"""Type-specific enrichment: email/URL/phone/MIME/language/name detection.

The port's counterpart of the JAX package's `ops/enrich.py`. Every stage
but `PhoneVectorizer` is a host stage of pure Python, copied rule for
rule so that both packages give equal outputs; `PhoneVectorizer`'s
device side is a concatenation of its host-prepared validity blocks.

Reference parity:
- `core/.../feature/PhoneNumberParser.scala` (libphonenumber validity) →
  region-aware digit rules here (pure python; no JVM libphonenumber)
- `ValidEmailTransformer` (core/.../feature/ValidEmailTransformer.scala)
- Email/URL domain pivots (`core/.../dsl/RichTextFeature.scala:603-688`,
  `EmailToPickListMapTransformer.scala`)
- `MimeTypeDetector` (core/.../feature/MimeTypeDetector.scala — Tika) →
  magic-byte table here
- `LangDetector` (core/.../feature/LangDetector.scala +
  `OptimaizeLanguageDetector.scala:45`) → script ranges + stopword-profile
  scoring (pure python, `utils/language.py`)
- `HumanNameDetector`/gender (`features/.../impl/feature/
  GenderDetectStrategy.scala`, OpenNLPNameEntityTagger.scala:42) →
  dictionary heuristic, and the packaged OpenNLP models
  (`utils/opennlp.py`) for named entities

Where the phone rules part from the Scala reference, the port follows
the JAX package, so that the two packages agree:
- an input shorter than 2 characters (or one with no digit) gives
  validity False and no parsed number; the reference's validate and parse
  give None (a null Binary or Phone) for inputs shorter than 2
  characters;
- an extension ("x12", "ext. 55") is not parsed: its digits join the
  national number (usually making it too long), where the reference's
  parse appends the extension to the normalized number.

All are host-side stages: their outputs (Binary/PickList/Text/maps) feed
the standard vectorizers, so the device program sees only dense encodings.
"""

from __future__ import annotations

import base64
import binascii
import logging
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.data.metadata import (
    NULL_INDICATOR, VectorColumnMetadata, VectorMetadata)
from transmogrifai_tpu_torch.stages.base import HostTransformer, Transformer
from transmogrifai_tpu_torch.utils.language import detect_language

log = logging.getLogger(__name__)

# --------------------------------------------------------------------------- #
# email                                                                       #
# --------------------------------------------------------------------------- #

_EMAIL_RE = re.compile(
    r"^[A-Za-z0-9!#$%&'*+/=?^_`{|}~.-]+@([A-Za-z0-9-]+\.)+[A-Za-z]{2,}$")


def email_parts(s: Optional[str]):
    """(prefix, domain) or (None, None) when invalid."""
    if not s or not _EMAIL_RE.match(s):
        return None, None
    prefix, domain = s.rsplit("@", 1)
    return prefix, domain


class ValidEmailTransformer(HostTransformer):
    """Email → Binary validity (ValidEmailTransformer.scala)."""

    in_types = (T.Email,)
    out_type = T.Binary

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        src = cols[0].data
        return Column.from_values(T.Binary, [
            None if v is None else (email_parts(v)[1] is not None)
            for v in src])


class EmailDomainTransformer(HostTransformer):
    """Email → PickList of the domain (EmailDomainToPickList,
    RichTextFeature.scala:630); invalid/empty → None."""

    in_types = (T.Email,)
    out_type = T.PickList

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        out = np.empty(len(cols[0].data), dtype=object)
        for i, v in enumerate(cols[0].data):
            out[i] = email_parts(v)[1]
        return Column(T.PickList, out)


class EmailToPickListMapTransformer(HostTransformer):
    """Email → PickListMap {Prefix, Domain}
    (EmailToPickListMapTransformer.scala)."""

    in_types = (T.Email,)
    out_type = T.PickListMap

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        out = np.empty(len(cols[0].data), dtype=object)
        for i, v in enumerate(cols[0].data):
            prefix, domain = email_parts(v)
            out[i] = ({"Prefix": prefix, "Domain": domain}
                      if domain is not None else None)
        return Column(T.PickListMap, out)


# --------------------------------------------------------------------------- #
# URL                                                                         #
# --------------------------------------------------------------------------- #

_URL_RE = re.compile(
    r"^(?P<proto>https?|ftp)://(?P<host>[A-Za-z0-9.-]+\.[A-Za-z]{2,})"
    r"(?::\d+)?(?:/[^\s]*)?$", re.IGNORECASE)


def url_parts(s: Optional[str]):
    """(protocol, domain) of a valid http/https/ftp url, else (None, None)
    (URLIsValid / URLDomainToText, RichTextFeature.scala:642-654)."""
    if not s:
        return None, None
    m = _URL_RE.match(s.strip())
    if not m:
        return None, None
    return m.group("proto").lower(), m.group("host").lower()


class UrlIsValidTransformer(HostTransformer):
    in_types = (T.URL,)
    out_type = T.Binary

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        return Column.from_values(T.Binary, [
            None if v is None else (url_parts(v)[1] is not None)
            for v in cols[0].data])


class UrlDomainTransformer(HostTransformer):
    """URL → PickList domain of VALID urls (URLDomainToPickList,
    RichTextFeature.scala:843)."""

    in_types = (T.URL,)
    out_type = T.PickList

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        out = np.empty(len(cols[0].data), dtype=object)
        for i, v in enumerate(cols[0].data):
            out[i] = url_parts(v)[1]
        return Column(T.PickList, out)


class UrlProtocolTransformer(HostTransformer):
    in_types = (T.URL,)
    out_type = T.Text

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        out = np.empty(len(cols[0].data), dtype=object)
        for i, v in enumerate(cols[0].data):
            out[i] = url_parts(v)[0]
        return Column(T.Text, out)


# --------------------------------------------------------------------------- #
# phone                                                                       #
# --------------------------------------------------------------------------- #

# national number length rules per region (libphonenumber-lite: the
# reference wraps full libphonenumber metadata; this table carries the
# country code + national-number length window for the ~40 most common
# calling regions, plus NANP structural rules below):
# region → (country_code, min_len, max_len)
_PHONE_REGIONS: Dict[str, tuple] = {
    "US": ("1", 10, 10), "CA": ("1", 10, 10), "GB": ("44", 9, 10),
    "DE": ("49", 6, 11), "FR": ("33", 9, 9), "IN": ("91", 10, 10),
    "AU": ("61", 9, 9), "JP": ("81", 9, 10), "BR": ("55", 10, 11),
    "MX": ("52", 10, 10), "CN": ("86", 10, 11), "ES": ("34", 9, 9),
    "IT": ("39", 8, 11), "NL": ("31", 9, 9), "SE": ("46", 7, 9),
    "NO": ("47", 8, 8), "DK": ("45", 8, 8), "FI": ("358", 5, 10),
    "PL": ("48", 9, 9), "CZ": ("420", 9, 9), "SK": ("421", 9, 9),
    "AT": ("43", 7, 11), "CH": ("41", 9, 9), "BE": ("32", 8, 9),
    "PT": ("351", 9, 9), "GR": ("30", 10, 10), "IE": ("353", 7, 9),
    "RU": ("7", 10, 10), "UA": ("380", 9, 9), "TR": ("90", 10, 10),
    "IL": ("972", 8, 9), "SA": ("966", 8, 9), "AE": ("971", 8, 9),
    "EG": ("20", 8, 10), "ZA": ("27", 9, 9), "NG": ("234", 7, 10),
    "KE": ("254", 9, 9), "KR": ("82", 8, 10), "SG": ("65", 8, 8),
    "HK": ("852", 8, 8), "TW": ("886", 8, 9), "TH": ("66", 8, 9),
    "VN": ("84", 9, 10), "ID": ("62", 8, 12), "MY": ("60", 9, 10),
    "PH": ("63", 8, 10), "PK": ("92", 9, 10), "BD": ("880", 8, 10),
    "AR": ("54", 10, 10), "CL": ("56", 9, 9), "CO": ("57", 10, 10),
    "PE": ("51", 9, 9), "NZ": ("64", 8, 10),
}

# country code → (min_len, max_len) for resolving "+cc..." numbers from
# OTHER regions against their own length window (longest-prefix match)
_CC_LENGTHS: Dict[str, tuple] = {}
for _region, (_cc, _lo, _hi) in _PHONE_REGIONS.items():
    prev = _CC_LENGTHS.get(_cc)
    _CC_LENGTHS[_cc] = ((min(prev[0], _lo), max(prev[1], _hi))
                        if prev else (_lo, _hi))


def _nanp_valid(national: str) -> bool:
    """NANP structure (US/CA): NXX-NXX-XXXX with N in 2-9 for the area
    and exchange codes (libphonenumber's generalDesc pattern)."""
    return (len(national) == 10 and national[0] not in "01"
            and national[3] not in "01")


# libphonenumber's region sentinel for "+"-prefixed numbers whose region
# is carried by the number itself (PhoneNumberParser.scala:256)
INTERNATIONAL_REGION = "ZZ"

# region → comma-separated country names, the resolution table behind
# country-name region matching (PhoneNumberParser.DefaultCountryCodes,
# PhoneNumberParser.scala:327-…; ours covers every region in
# _PHONE_REGIONS rather than only the NANP islands)
_COUNTRY_NAMES: Dict[str, str] = {
    "US": "USA, United States of America, United States",
    "CA": "Canada", "GB": "United Kingdom, Great Britain, England",
    "DE": "Germany, Deutschland", "FR": "France", "IN": "India",
    "AU": "Australia", "JP": "Japan", "BR": "Brazil, Brasil",
    "MX": "Mexico", "CN": "China", "ES": "Spain, Espana",
    "IT": "Italy, Italia", "NL": "Netherlands, Holland", "SE": "Sweden",
    "NO": "Norway", "DK": "Denmark", "FI": "Finland", "PL": "Poland",
    "CZ": "Czech Republic, Czechia", "SK": "Slovakia", "AT": "Austria",
    "CH": "Switzerland", "BE": "Belgium", "PT": "Portugal",
    "GR": "Greece", "IE": "Ireland", "RU": "Russia, Russian Federation",
    "UA": "Ukraine", "TR": "Turkey, Turkiye", "IL": "Israel",
    "SA": "Saudi Arabia", "AE": "United Arab Emirates, UAE",
    "EG": "Egypt", "ZA": "South Africa", "NG": "Nigeria", "KE": "Kenya",
    "KR": "South Korea, Korea, Republic of Korea", "SG": "Singapore",
    "HK": "Hong Kong", "TW": "Taiwan", "TH": "Thailand",
    "VN": "Vietnam, Viet Nam", "ID": "Indonesia", "MY": "Malaysia",
    "PH": "Philippines", "PK": "Pakistan", "BD": "Bangladesh",
    "AR": "Argentina", "CL": "Chile", "CO": "Colombia", "PE": "Peru",
    "NZ": "New Zealand",
}


def _parse_parts(s: str, default_region: str = "US", strict: bool = False):
    """(valid, country_code, national_number) for a non-None input.

    The shared core behind `is_valid_phone` and `parse_phone`
    (PhoneNumberParser.scala parsePhoneNumber/validate/parse:270-322).
    `country_code` is "" when the calling code cannot be resolved
    (unknown "+cc" prefix) and None when invalid."""
    digits = re.sub(r"[^\d+]", "", s.strip())
    if not digits:
        return False, None, None
    region = default_region.upper()
    known = region in _PHONE_REGIONS
    cc, lo, hi = _PHONE_REGIONS.get(region, ("", 7, 15))

    def _check(cc_used: str, national: str, lo_: int, hi_: int) -> bool:
        if cc_used == "1":
            return _nanp_valid(national)
        return lo_ <= len(national) <= hi_

    if digits.startswith("+"):
        body = digits[1:]
        if not body.isdigit():
            return False, None, None
        if known and body.startswith(cc):
            nat = body[len(cc):]
            return _check(cc, nat, lo, hi), cc, nat
        # another country's code: longest-prefix match into the table
        for plen in (3, 2, 1):
            pref = body[:plen]
            if pref in _CC_LENGTHS:
                flo, fhi = _CC_LENGTHS[pref]
                nat = body[plen:]
                return _check(pref, nat, flo, fhi), pref, nat
        # unknown code: generic E.164 bound; calling code unresolvable
        return 7 <= len(body) <= 15, "", body
    if not digits.isdigit():
        return False, None, None
    if region == INTERNATIONAL_REGION:
        # "ZZ" carries no national metadata — only "+" numbers resolve
        # (libphonenumber parse throws for ZZ without "+")
        return False, None, None
    if known and digits.startswith(cc) and \
            _check(cc, digits[len(cc):], lo, hi):
        return ((not strict or region in ("US", "CA")),
                cc, digits[len(cc):])
    # bare national number: NANP structure only for NANP default regions;
    # unknown regions keep the generic (7, 15) window
    if known and cc == "1":
        return _nanp_valid(digits), cc, digits
    if lo <= len(digits) <= hi:
        # normalization strips the national trunk 0 where the remainder
        # still fits the window — Italy keeps its leading zero as part of
        # the significant number (libphonenumber nationalPrefix metadata)
        if (digits.startswith("0") and region != "IT"
                and lo <= len(digits) - 1 <= hi):
            return True, cc, digits[1:]
        return True, cc, digits
    # national trunk prefix: most non-NANP regions write national numbers
    # with a leading 0 that is not part of the significant number
    # (libphonenumber's nationalPrefix strip); Italy's zero is significant,
    # so IT numbers must fit the window zero included (branch above)
    if (digits.startswith("0") and region != "IT"
            and lo <= len(digits) - 1 <= hi):
        return True, cc, digits[1:]
    return False, None, None


def is_valid_phone(s: Optional[str], default_region: str = "US",
                   strict: bool = False) -> Optional[bool]:
    """Region-aware validity (PhoneNumberParser.scala: validity against a
    default region; non-strict mode tolerates missing country code).
    "+cc" numbers from a different region validate against THAT region's
    length window via longest-code match; NANP numbers additionally check
    the N[2-9]XX area/exchange structure."""
    if s is None:
        return None
    return _parse_parts(s, default_region, strict)[0]


def parse_phone(s: Optional[str], default_region: str = "US",
                strict: bool = False) -> Optional[str]:
    """Normalize to "+{countryCode}{nationalNumber}" when valid, else None
    (PhoneNumberParser.parse, PhoneNumberParser.scala:314-322). Numbers
    whose calling code cannot be resolved (unknown "+cc") return None even
    when length-valid, matching the reference's isValidNumber gate."""
    if s is None:
        return None
    valid, cc, nat = _parse_parts(s, default_region, strict)
    if not valid or not cc:
        return None
    return f"+{cc}{nat}"


def _char_bigrams(s: str):
    return {s[i:i + 2] for i in range(len(s) - 1)}


def _name_bigrams(codes: Dict[str, str]):
    return [(reg, _char_bigrams(name.strip().upper()))
            for reg, names in codes.items()
            for name in str(names).split(",")]


_DEFAULT_NAME_BIGRAMS = _name_bigrams(_COUNTRY_NAMES)
_REGION_CACHE: Dict[str, str] = {}


def resolve_region(phone: Optional[str], region_text: Optional[str] = None,
                   default_region: str = "US",
                   country_codes: Optional[Dict[str, str]] = None) -> str:
    """Resolve the validation region for a (phone, region-text) pair
    (PhoneNumberParser.validCountryCode, PhoneNumberParser.scala:285-305):
    "+" numbers resolve to the international sentinel; a recognized region
    code wins; otherwise the nearest country NAME by character-bigram
    Jaccard similarity over `country_codes` (region → comma-separated
    names; defaults to the built-in table); else the default region."""
    if phone and phone.strip().startswith("+"):
        return INTERNATIONAL_REGION
    if region_text and region_text.strip():
        rc = region_text.strip().upper()
        codes = country_codes if country_codes else _COUNTRY_NAMES
        if rc in codes or rc in _PHONE_REGIONS:
            return rc
        if country_codes:
            entries = _name_bigrams(country_codes)
        else:
            # region texts are low-cardinality in practice — cache the
            # name-match result so per-row calls don't rescan the table
            if rc in _REGION_CACHE:
                return _REGION_CACHE[rc]
            entries = _DEFAULT_NAME_BIGRAMS
        q = _char_bigrams(rc)
        best, best_sim = None, 0.0
        for reg, b in entries:
            union = len(q | b)
            sim = len(q & b) / union if union else 0.0
            if sim > best_sim:
                best, best_sim = reg, sim
        if best is not None:
            if not country_codes and len(_REGION_CACHE) < 4096:
                _REGION_CACHE[rc] = best
            return best
    return default_region.upper()


def phone_valid_block(values, default_region: str,
                      track_nulls: bool) -> np.ndarray:
    """[isValid(, isNull)] block shared by PhoneVectorizer and
    PhoneMapVectorizer so scalar and map phone encodings cannot drift."""
    n = len(values)
    block = np.zeros((n, 2 if track_nulls else 1), dtype=np.float32)
    for i, v in enumerate(values):
        valid = is_valid_phone(v, default_region)
        if valid is None:
            if track_nulls:
                block[i, 1] = 1.0
        elif valid:
            block[i, 0] = 1.0
    return block


class PhoneIsValidTransformer(HostTransformer):
    """Phone → Binary validity (RichTextFeature.isValidPhoneDefaultCountry,
    RichTextFeature.scala:545)."""

    in_types = (T.Phone,)
    out_type = T.Binary

    def __init__(self, default_region: str = "US", strict: bool = False,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, default_region=default_region, strict=strict)
        self.default_region = default_region
        self.strict = strict

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        return Column.from_values(T.Binary, [
            is_valid_phone(v, self.default_region, self.strict)
            for v in cols[0].data])


class PhoneIsValidWithRegionTransformer(HostTransformer):
    """(Phone, Text region) → Binary validity with per-row region
    resolution incl. country-name matching (IsValidPhoneNumber,
    PhoneNumberParser.scala:198-215)."""

    in_types = (T.Phone, T.Text)
    out_type = T.Binary

    def __init__(self, default_region: str = "US", strict: bool = False,
                 country_codes: Optional[Dict[str, str]] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, default_region=default_region,
                         strict=strict, country_codes=country_codes)
        self.default_region = default_region
        self.strict = strict
        self.country_codes = country_codes

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        return Column.from_values(T.Binary, [
            is_valid_phone(p, resolve_region(p, r, self.default_region,
                                             self.country_codes),
                           self.strict)
            for p, r in zip(cols[0].data, cols[1].data)])


class PhoneParseTransformer(HostTransformer):
    """Phone → normalized "+cc…" Phone against the default region, None
    when invalid (ParsePhoneDefaultCountry, PhoneNumberParser.scala:170-179)."""

    in_types = (T.Phone,)
    out_type = T.Phone

    def __init__(self, default_region: str = "US", strict: bool = False,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, default_region=default_region, strict=strict)
        self.default_region = default_region
        self.strict = strict

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        return Column.from_values(T.Phone, [
            parse_phone(v, self.default_region, self.strict)
            for v in cols[0].data])


class PhoneParseWithRegionTransformer(HostTransformer):
    """(Phone, Text region) → normalized Phone with per-row region
    resolution (ParsePhoneNumber, PhoneNumberParser.scala:143-159)."""

    in_types = (T.Phone, T.Text)
    out_type = T.Phone

    def __init__(self, default_region: str = "US", strict: bool = False,
                 country_codes: Optional[Dict[str, str]] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, default_region=default_region,
                         strict=strict, country_codes=country_codes)
        self.default_region = default_region
        self.strict = strict
        self.country_codes = country_codes

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        return Column.from_values(T.Phone, [
            parse_phone(p, resolve_region(p, r, self.default_region,
                                          self.country_codes),
                        self.strict)
            for p, r in zip(cols[0].data, cols[1].data)])


class PhoneMapIsValidTransformer(HostTransformer):
    """PhoneMap → BinaryMap per-key validity; keys whose value is None are
    dropped, matching the reference's SomeValue collect
    (IsValidPhoneMapDefaultCountry, PhoneNumberParser.scala:241-251)."""

    in_types = (T.PhoneMap,)
    out_type = T.BinaryMap

    def __init__(self, default_region: str = "US", strict: bool = False,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, default_region=default_region, strict=strict)
        self.default_region = default_region
        self.strict = strict

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        out: List[Optional[Dict[str, bool]]] = []
        for m in cols[0].data:
            if m is None:
                out.append(None)
                continue
            d = {}
            for k, v in m.items():
                valid = is_valid_phone(v, self.default_region, self.strict)
                if valid is not None:
                    d[k] = valid
            out.append(d)
        return Column.from_values(T.BinaryMap, out)


class PhoneVectorizer(Transformer):
    """N Phone features → [isValid, isNull] per feature — the transmogrify
    default for Phone (RichTextFeature.vectorize, :569-582)."""

    in_types = (T.Phone, Ellipsis)
    out_type = T.OPVector

    def __init__(self, default_region: str = "US", track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, default_region=default_region,
                         track_nulls=track_nulls)
        self.default_region = default_region
        self.track_nulls = track_nulls

    def host_prepare(self, cols: Sequence[Optional[Column]]):
        return [phone_valid_block(c.data, self.default_region,
                                  self.track_nulls) for c in cols]

    def device_apply(self, enc, dev):
        return torch.cat(list(enc), dim=1)

    def output_meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for f in self.input_features:
            cols.append(VectorColumnMetadata(
                parent_name=f.name, parent_type=f.ftype.__name__,
                grouping=f.name, indicator_value="IsValid"))
            if self.track_nulls:
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    grouping=f.name, indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()


# --------------------------------------------------------------------------- #
# MIME type (Base64 payloads)                                                 #
# --------------------------------------------------------------------------- #

_MAGIC = [
    (b"%PDF", "application/pdf"),
    (b"\x89PNG\r\n\x1a\n", "image/png"),
    (b"\xff\xd8\xff", "image/jpeg"),
    (b"GIF8", "image/gif"),
    (b"BM", "image/bmp"),
    (b"PK\x03\x04", "application/zip"),
    (b"\x1f\x8b", "application/gzip"),
    (b"Rar!", "application/x-rar-compressed"),
    (b"\x7fELF", "application/x-executable"),
    (b"MZ", "application/x-msdownload"),
    (b"ID3", "audio/mpeg"),
    (b"RIFF", "audio/x-wav"),
    (b"OggS", "audio/ogg"),
    (b"\xd0\xcf\x11\xe0", "application/x-ole-storage"),
]


def detect_mime(b64: Optional[str], type_hint: Optional[str] = None) -> Optional[str]:
    """Magic-byte MIME sniffing of base64 payloads (MimeTypeDetector.scala —
    Tika's detector behind the same Base64 → Text contract)."""
    if b64 is None:
        return None
    if not b64:
        return ""
    try:
        raw = base64.b64decode(b64, validate=True)
    except (binascii.Error, ValueError):
        return None
    if not raw:
        return ""
    for magic, mime in _MAGIC:
        if raw.startswith(magic):
            return mime
    head = raw[:512]
    try:
        text = head.decode("utf-8")
    except UnicodeDecodeError:
        return type_hint or "application/octet-stream"
    stripped = text.lstrip().lower()
    if stripped.startswith(("<html", "<!doctype html")):
        return "text/html"
    if stripped.startswith("<?xml"):
        return "application/xml"
    if stripped.startswith(("{", "[")):
        return "application/json"
    if stripped.startswith("<svg"):
        return "image/svg+xml"
    return type_hint or "text/plain"


class MimeTypeDetector(HostTransformer):
    """Base64 → Text MIME type (MimeTypeDetector.scala)."""

    in_types = (T.Base64,)
    out_type = T.Text

    def __init__(self, type_hint: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, type_hint=type_hint)
        self.type_hint = type_hint

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        out = np.empty(len(cols[0].data), dtype=object)
        for i, v in enumerate(cols[0].data):
            out[i] = detect_mime(v, self.type_hint)
        return Column(T.Text, out)


# --------------------------------------------------------------------------- #
# language detection                                                          #
# --------------------------------------------------------------------------- #

# `detect_language` (utils/language.py): script histograms +
# Cavnar-Trenkle trigram rank profiles + distinctive-char evidence, the
# Optimaize technique reimplemented from scratch


class LangDetector(HostTransformer):
    """Text → RealMap of language → confidence (LangDetector.scala)."""

    in_types = (T.Text,)
    out_type = T.RealMap

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        out = np.empty(len(cols[0].data), dtype=object)
        for i, v in enumerate(cols[0].data):
            d = detect_language(v)
            out[i] = d if d else None
        return Column(T.RealMap, out)


# --------------------------------------------------------------------------- #
# human names                                                                 #
# --------------------------------------------------------------------------- #

_FEMALE = frozenset("""
mary patricia jennifer linda elizabeth barbara susan jessica sarah karen
nancy lisa margaret betty sandra ashley dorothy kimberly emily donna
michelle carol amanda melissa deborah stephanie rebecca laura sharon
cynthia kathleen amy shirley angela helen anna brenda pamela nicole emma
samantha katherine christine debra rachel catherine carolyn janet ruth
maria heather diane virginia julie joyce victoria olivia kelly christina
lauren joan evelyn judith megan cheryl andrea hannah martha jacqueline
frances gloria ann teresa kathryn sara janice jean alice madison doris
abigail julia judy grace denise amber marilyn beverly danielle theresa
sophia marie diana brittany natalie isabella charlotte rose alexis kayla
""".split())

_MALE = frozenset("""
james robert john michael david william richard joseph thomas charles
christopher daniel matthew anthony mark donald steven paul andrew joshua
kenneth kevin brian george timothy ronald edward jason jeffrey ryan jacob
gary nicholas eric jonathan stephen larry justin scott brandon benjamin
samuel gregory frank alexander raymond patrick jack dennis jerry tyler
aaron jose adam nathan henry douglas zachary peter kyle ethan walter noah
jeremy christian keith roger terry austin sean gerald carl harold dylan
arthur lawrence jordan jesse bryan billy bruce gabriel joe logan alan
juan albert willie elijah wayne randy vincent mason roy ralph bobby
russell bradley philip eugene
""".split())


def name_stats(text: Optional[str]) -> Optional[Dict[str, str]]:
    """NameStats map {isName, gender[, firstName]} — HumanNameDetector /
    GenderDetectStrategy.ByFirstName analogue over a name dictionary."""
    if not text:
        return None
    tokens = [t.lower() for t in re.findall(r"[A-Za-zà-ÿ'-]+", text)]
    if not 1 <= len(tokens) <= 4:
        return {"isName": "false", "gender": "unknown"}
    first = tokens[0]
    if first in _FEMALE:
        return {"isName": "true", "gender": "female", "firstName": first}
    if first in _MALE:
        return {"isName": "true", "gender": "male", "firstName": first}
    # any dictionary hit in later tokens (e.g. "dr maria lopez")
    for t in tokens[1:]:
        if t in _FEMALE:
            return {"isName": "true", "gender": "female", "firstName": t}
        if t in _MALE:
            return {"isName": "true", "gender": "male", "firstName": t}
    return {"isName": "false", "gender": "unknown"}


class HumanNameDetector(HostTransformer):
    """Text → NameStats (HumanNameDetector.scala / GenderDetectStrategy)."""

    in_types = (T.Text,)
    out_type = T.NameStats

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        out = np.empty(len(cols[0].data), dtype=object)
        for i, v in enumerate(cols[0].data):
            out[i] = name_stats(v)
        return Column(T.NameStats, out)


class NameEntityRecognizer(HostTransformer):
    """Text → MultiPickListMap of entity type → tokens
    (OpenNLPNameEntityTagger.scala:42 contract).

    When a directory of OpenNLP 1.5-format models is configured
    (`TRANSMOGRIFAI_OPENNLP_DIR` or `model_dir=`), the REAL trained
    maxent models run through the native loader (`utils/opennlp.py`):
    text → SentenceDetector → TokenizerME → per-entity NameFinder beam
    search, exactly the reference's tagger pipeline. With no models
    available it falls back to the capitalization + name-dictionary
    heuristic."""

    in_types = (T.Text,)
    out_type = T.MultiPickListMap

    def __init__(self, language: str = "es", model_dir: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, language=language, model_dir=model_dir)
        self.language = language
        self._model_dir = model_dir
        self._pipeline = None  # lazy (sentence, tokenizer, {entity: finder})

    def _load_pipeline(self):
        if self._pipeline is not None:
            return self._pipeline
        self._pipeline = False
        try:
            from transmogrifai_tpu_torch.utils import opennlp as onlp
            mods = onlp.available_models(self._model_dir)
            finders = {}
            for key, path in mods.items():
                pre = f"{self.language}-ner-"
                if key.startswith(pre):
                    finders[key[len(pre):]] = onlp.NameFinder(
                        onlp.load_model(path))
            if finders:
                def _maybe(key):
                    return (onlp.load_model(mods[key]) if key in mods
                            else None)
                sent = _maybe(f"{self.language}-sent") or _maybe("en-sent")
                tok = _maybe(f"{self.language}-token") or _maybe("en-token")
                self._pipeline = (
                    onlp.SentenceDetector(sent) if sent else None,
                    onlp.TokenizerME(tok) if tok else None,
                    finders)
        except Exception:
            log.exception("OpenNLP models unavailable; heuristic NER")
        return self._pipeline

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        pipe = self._load_pipeline()
        out = np.empty(len(cols[0].data), dtype=object)
        for i, v in enumerate(cols[0].data):
            out[i] = (self._entities_model(v, pipe) if pipe
                      else self._entities(v))
        return Column(T.MultiPickListMap, out)

    @staticmethod
    def _entities_model(text: Optional[str], pipe
                        ) -> Optional[Dict[str, frozenset]]:
        if not text:
            return None
        sent_d, tok_d, finders = pipe
        sentences = sent_d.split(text) if sent_d else [text]
        found: Dict[str, set] = {}
        for s in sentences:
            tokens = tok_d.tokenize(s) if tok_d else s.split()
            for entity, finder in finders.items():
                for a, b, _ in finder.spans(tokens):
                    found.setdefault(entity.capitalize(), set()).add(
                        " ".join(tokens[a:b]).lower())
        if not found:
            return None
        return {k: frozenset(v) for k, v in found.items()}

    @staticmethod
    def _entities(text: Optional[str]) -> Optional[Dict[str, frozenset]]:
        if not text:
            return None
        persons = set()
        for m in re.finditer(r"\b([A-Z][a-zà-ÿ'-]+)(?:\s+[A-Z][a-zà-ÿ'-]+)*",
                             text):
            first = m.group(1).lower()
            if first in _FEMALE or first in _MALE:
                persons.add(m.group(0).lower())
        return {"Person": frozenset(persons)} if persons else None
