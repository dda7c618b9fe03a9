"""OpenNLP binary model loader + decoders (sentence / token / NER).

The port's copy of the JAX package's `utils/opennlp.py` (pure Python:
the same parameter sums in the same order, so spans and tags are equal).
Its packaged models are the port's own copy of the binaries.

Reference parity: the reference packages trained OpenNLP 1.5 models under
`models/src/main/resources/OpenNLP/` and drives them through
`core/.../utils/text/OpenNLPNameEntityTagger.scala:42` /
`OpenNLPAnalyzer.scala` / `OpenNLPSentenceSplitter.scala`. This module is
a from-scratch Python reader for the same PUBLIC model format (Apache
OpenNLP GIS maxent / perceptron binaries inside a zip container) plus the
matching context generators, so those exact models — or any user-supplied
OpenNLP 1.5-format model — run natively here with no JVM.

Format (java DataOutputStream, big-endian):
    UTF magic ("GIS" | "Perceptron")
    GIS only: int correctionConstant, double correctionParam
    int nOutcomes, then outcome labels (UTF)
    int nPatterns, then patterns: UTF "count oc1 oc2 ..." — `count`
        predicates share the outcome set {oc1, oc2, ...}
    int nPreds, then predicate names (UTF), grouped by pattern
    doubles: for each predicate, one parameter per outcome in its pattern

Evaluation: p(o | context) ∝ exp(Σ params_o over active predicates) —
for these models correctionConstant=1 / correctionParam=0, so the GIS
correction terms vanish. Unknown predicates simply don't contribute.

Feature templates below were recovered from the models' own predicate
vocabularies (the names are self-documenting: "w&c=", "p1f1=", "eos=",
…), then validated behaviorally (abbreviation-safe sentence splits,
punctuation tokenization, multi-token person names).

Model discovery: set `TRANSMOGRIFAI_OPENNLP_DIR` (or pass `model_dir`)
to a directory of OpenNLP `.bin` files named like `en-sent.bin`,
`en-token.bin`, `es-ner-person.bin`; with nothing configured, the
PACKAGED models under `transmogrifai_tpu_torch/resources/opennlp/` (a curated
subset of the Apache-licensed binaries the reference ships as its
`models/` module) are used, so standalone deployments get real
maxent/perceptron decoding by default.
"""

from __future__ import annotations

import math
import os
import re
import struct
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "MaxentModel", "SentenceDetector", "TokenizerME", "NameFinder",
    "POSTagger", "load_model", "load_tag_dictionary", "model_dir",
    "available_models",
]


# --------------------------------------------------------------------- #
# binary reader                                                         #
# --------------------------------------------------------------------- #

class _JDis:
    """java.io.DataInputStream reader (big-endian, modified-UTF strings)."""

    def __init__(self, data: bytes):
        self._b = data
        self._o = 0

    def utf(self) -> str:
        n = struct.unpack_from(">H", self._b, self._o)[0]
        self._o += 2
        s = self._b[self._o:self._o + n].decode("utf-8", "replace")
        self._o += n
        return s

    def i4(self) -> int:
        v = struct.unpack_from(">i", self._b, self._o)[0]
        self._o += 4
        return v

    def f8(self) -> float:
        v = struct.unpack_from(">d", self._b, self._o)[0]
        self._o += 8
        return v

    def f8n(self, n: int) -> Tuple[float, ...]:
        v = struct.unpack_from(f">{n}d", self._b, self._o)
        self._o += 8 * n
        return v


class MaxentModel:
    """GIS maxent / perceptron model: predicate → sparse outcome params."""

    def __init__(self, outcomes: List[str],
                 params: Dict[str, Tuple[Tuple[int, ...], Tuple[float, ...]]],
                 kind: str):
        self.outcomes = outcomes
        self.params = params
        self.kind = kind

    def eval(self, context: Sequence[str]) -> List[float]:
        """p(outcome | active predicates); unknown predicates are no-ops."""
        sums = [0.0] * len(self.outcomes)
        for pred in context:
            entry = self.params.get(pred)
            if entry is None:
                continue
            ocs, ps = entry
            for i, o in enumerate(ocs):
                sums[o] += ps[i]
        mx = max(sums)
        exps = [math.exp(s - mx) for s in sums]
        z = sum(exps)
        return [e / z for e in exps]

    def best(self, context: Sequence[str]) -> str:
        probs = self.eval(context)
        return self.outcomes[probs.index(max(probs))]


def _read_maxent(data: bytes) -> MaxentModel:
    d = _JDis(data)
    magic = d.utf()
    if magic == "GIS":
        d.i4()   # correctionConstant (1 in all shipped models)
        d.f8()   # correctionParam (0.0)
    elif magic != "Perceptron":
        raise ValueError(f"unsupported OpenNLP model type {magic!r}")
    n_out = d.i4()
    outcomes = [d.utf() for _ in range(n_out)]
    n_pat = d.i4()
    patterns: List[Tuple[int, Tuple[int, ...]]] = []
    for _ in range(n_pat):
        parts = d.utf().split()
        patterns.append((int(parts[0]), tuple(int(x) for x in parts[1:])))
    n_pred = d.i4()
    preds = [d.utf() for _ in range(n_pred)]
    params: Dict[str, Tuple[Tuple[int, ...], Tuple[float, ...]]] = {}
    pi = 0
    for count, ocs in patterns:
        for _ in range(count):
            params[preds[pi]] = (ocs, d.f8n(len(ocs)))
            pi += 1
    if pi != n_pred:
        raise ValueError(f"pattern counts {pi} != predicate count {n_pred}")
    return MaxentModel(outcomes, params, magic)


def load_model(path: str) -> MaxentModel:
    """Read a `.bin` zip container (manifest.properties + *.model)."""
    with zipfile.ZipFile(path) as z:
        entry = next(n for n in z.namelist() if n.endswith(".model"))
        return _read_maxent(z.read(entry))


_PACKAGED_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "resources", "opennlp")


def model_dir() -> Optional[str]:
    d = os.environ.get("TRANSMOGRIFAI_OPENNLP_DIR")
    if d and os.path.isdir(d):
        return d
    if os.path.isdir(_PACKAGED_DIR):
        return _PACKAGED_DIR
    return None


def available_models(directory: Optional[str] = None) -> Dict[str, str]:
    """{model key like 'es-ner-person': path} for *.bin in the dir."""
    d = directory or model_dir()
    if not d or not os.path.isdir(d):
        return {}
    out = {}
    for f in sorted(os.listdir(d)):
        if f.endswith(".bin"):
            out[f[:-4]] = os.path.join(d, f)
    return out


# --------------------------------------------------------------------- #
# token class (FeatureGeneratorUtil.tokenFeature)                       #
# --------------------------------------------------------------------- #

_RE_LC = re.compile(r"^[a-zà-öø-ÿа-я]+$")
_RE_SC = re.compile(r"^[A-ZÀ-ÖØ-Þ]$")
_RE_AC = re.compile(r"^[A-ZÀ-ÖØ-Þ]+$")
_RE_IC = re.compile(r"^[A-ZÀ-ÖØ-Þ][a-zà-öø-ÿ]+$")
_RE_CP = re.compile(r"^[A-ZÀ-ÖØ-Þ][a-zà-öø-ÿ]*\.$")


def token_class(tok: str) -> str:
    """The 14 shape classes observed in the models' `wc=` vocabulary."""
    if _RE_LC.match(tok):
        return "lc"
    if _RE_SC.match(tok):
        return "sc"
    if _RE_IC.match(tok):
        return "ic"
    if _RE_CP.match(tok):
        return "cp"
    if _RE_AC.match(tok):
        return "ac"
    if any(c.isdigit() for c in tok):
        if tok.isdigit():
            if len(tok) == 2:
                return "2d"
            if len(tok) == 4:
                return "4d"
            return "num"
        if any(c.isalpha() for c in tok):
            return "an"
        if "-" in tok:
            return "dd"
        if "/" in tok:
            return "ds"
        if "," in tok:
            return "dc"
        if "." in tok:
            return "dp"
        return "num"
    return "other"


# --------------------------------------------------------------------- #
# sentence detector (DefaultSDContextGenerator features)                #
# --------------------------------------------------------------------- #

_EOS_CHARS = ".?!"
_WS_RE = re.compile(r"\s")


class SentenceDetector:
    """SentenceDetectorME: maxent decision at each eos-char candidate."""

    def __init__(self, model: MaxentModel):
        self.model = model
        self._split_idx = model.outcomes.index("s")

    def _context(self, text: str, pos: int) -> List[str]:
        # token region around the candidate char
        left = pos
        while left > 0 and not text[left - 1].isspace():
            left -= 1
        right = pos + 1
        while right < len(text) and not text[right].isspace():
            right += 1
        prefix = text[left:pos]
        suffix = text[pos + 1:right]
        # previous / next whitespace-separated words
        pws = text[:left].rstrip()
        ps = pws.rfind(" ")
        previous = pws[ps + 1:] if pws else ""
        nws = text[right:].lstrip()
        ns = nws.find(" ")
        nxt = nws[:ns] if ns >= 0 else nws
        feats = ["x=" + prefix]
        if prefix:
            feats.append(str(len(prefix)))
            if prefix[0].isupper():
                feats.append("xcap")
        feats.append("v=" + previous)
        if previous and previous[0].isupper():
            feats.append("vcap")
        feats.append("s=" + suffix)
        if suffix and suffix[0].isupper():
            feats.append("scap")
        feats.append("n=" + nxt)
        if nxt and nxt[0].isupper():
            feats.append("ncap")
        feats.append("eos=" + text[pos])
        return feats

    def split(self, text: str) -> List[str]:
        """Sentence strings (whitespace-trimmed)."""
        out: List[str] = []
        start = 0
        n = len(text)
        for i, ch in enumerate(text):
            if ch not in _EOS_CHARS:
                continue
            # candidate only at a token edge followed by whitespace/end
            if i + 1 < n and not text[i + 1].isspace():
                continue
            probs = self.model.eval(self._context(text, i))
            if probs[self._split_idx] > 0.5:
                sent = text[start:i + 1].strip()
                if sent:
                    out.append(sent)
                start = i + 1
        tail = text[start:].strip()
        if tail:
            out.append(tail)
        return out


# --------------------------------------------------------------------- #
# tokenizer (DefaultTokenContextGenerator features)                     #
# --------------------------------------------------------------------- #

_ALNUM_RE = re.compile(r"^[A-Za-z0-9]+$")


def _char_preds(key: str, c: str, feats: List[str]) -> None:
    feats.append(f"{key}={c}")
    if c.isalpha():
        feats.append(key + "_alpha")
        if c.isupper():
            feats.append(key + "_caps")
    elif c.isdigit():
        feats.append(key + "_num")
    elif c.isspace():
        feats.append(key + "_ws")
    elif c in ".?!":
        feats.append(key + "_eos")
    elif c in "`'\"":
        feats.append(key + "_quote")
    elif c in "([{":
        feats.append(key + "_lp")
    elif c in ")]}":
        feats.append(key + "_rp")


class TokenizerME:
    """Maxent tokenizer: split decision inside whitespace chunks."""

    def __init__(self, model: MaxentModel,
                 alpha_numeric_optimization: bool = True):
        self.model = model
        self._t = model.outcomes.index("T")
        self._alnum_opt = alpha_numeric_optimization

    def _context(self, chunk: str, i: int) -> List[str]:
        feats = ["p=" + chunk[:i], "s=" + chunk[i:]]
        if i > 0:
            _char_preds("p1", chunk[i - 1], feats)
            if i > 1:
                _char_preds("p2", chunk[i - 2], feats)
                feats.append("p21=" + chunk[i - 2:i])
            else:
                feats.append("p2=bok")
        else:
            feats.append("p1=bok")
        _char_preds("f1", chunk[i], feats)
        if i + 1 < len(chunk):
            _char_preds("f2", chunk[i + 1], feats)
            feats.append("f12=" + chunk[i:i + 2])
        else:
            feats.append("f2=bok")
        if i > 0:
            feats.append("p1f1=" + chunk[i - 1:i + 1])
        if chunk[0] == "&" and chunk[-1] == ";":
            feats.append("cc")  # HTML character-escape chunk
        return feats

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for chunk in text.split():
            if len(chunk) == 1 or (self._alnum_opt and _ALNUM_RE.match(chunk)):
                out.append(chunk)
                continue
            start = 0
            for i in range(1, len(chunk)):
                probs = self.model.eval(self._context(chunk, i))
                if probs[self._t] > 0.5:
                    out.append(chunk[start:i])
                    start = i
            out.append(chunk[start:])
        return [t for t in out if t]


# --------------------------------------------------------------------- #
# name finder (1.3-vintage NameContextGenerator + beam search)          #
# --------------------------------------------------------------------- #

class NameFinder:
    """NameFinderME over the es/nl CoNLL02 models: per-token maxent with
    prev-outcome features, beam-searched with the start/cont validity
    constraint (NameFinderSequenceValidator)."""

    BEAM = 3

    def __init__(self, model: MaxentModel):
        self.model = model
        self.outcomes = model.outcomes
        self._start = [o for o in self.outcomes if o.endswith("-start")]
        self._cont = {o: o.rsplit("-", 1)[0] for o in self.outcomes
                      if o.endswith("-cont")}

    def _context(self, tokens: List[str], i: int,
                 prev: str, pprev: str) -> List[str]:
        n = len(tokens)

        def tok(j: str):
            return tokens[j]

        w = tokens[i]
        lw = w.lower()
        feats = ["def", "w=" + lw, "wc=" + token_class(w),
                 "w&c=" + lw + "," + token_class(w)]
        for off, key in ((-2, "p2"), (-1, "p1"), (1, "n1"), (2, "n2")):
            j = i + off
            if 0 <= j < n:
                t = tokens[j]
                feats.append(f"{key}w={t.lower()}")
                feats.append(f"{key}wc={token_class(t)}")
                feats.append(f"{key}w&c={t.lower()},{token_class(t)}")
        # original-case bigrams
        if i > 0:
            feats.append(f"pw,w={tokens[i - 1]},{w}")
            feats.append(f"pwc,wc={token_class(tokens[i - 1])},"
                         f"{token_class(w)}")
        if i + 1 < n:
            feats.append(f"w,nw={w},{tokens[i + 1]}")
            feats.append(f"wc,nc={token_class(w)},{token_class(tokens[i + 1])}")
        # previous outcomes + document-level previous decision
        feats.append("po=" + prev)
        feats.append("ppo=" + pprev)
        feats.append("pow=" + prev + "," + w)
        feats.append("powf=" + prev + "," + token_class(w))
        feats.append("pd=null")
        if i == 0:
            feats.append("S=begin")
        return feats

    def _valid(self, outcome: str, prev: str) -> bool:
        ent = self._cont.get(outcome)
        if ent is None:
            return True
        return prev == ent + "-start" or prev == ent + "-cont"

    def tag(self, tokens: List[str]) -> List[str]:
        """Per-token outcome sequence via beam search."""
        if not tokens:
            return []
        beam: List[Tuple[float, List[str]]] = [(0.0, [])]
        for i in range(len(tokens)):
            nxt: List[Tuple[float, List[str]]] = []
            for score, seq in beam:
                prev = seq[-1] if seq else "other"
                pprev = seq[-2] if len(seq) > 1 else "other"
                probs = self.model.eval(
                    self._context(tokens, i, prev, pprev))
                for oi, p in enumerate(probs):
                    o = self.outcomes[oi]
                    if p <= 1e-9 or not self._valid(o, prev):
                        continue
                    nxt.append((score + math.log(p), seq + [o]))
            nxt.sort(key=lambda sp: -sp[0])
            beam = nxt[:self.BEAM] or [(0.0, (beam[0][1] + ["other"]))]
        return beam[0][1]

    def spans(self, tokens: List[str]) -> List[Tuple[int, int, str]]:
        """(start, end, entity) spans from the outcome sequence."""
        tags = self.tag(tokens)
        out: List[Tuple[int, int, str]] = []
        start = None
        ent = None
        for i, t in enumerate(tags):
            if t.endswith("-start"):
                if start is not None:
                    out.append((start, i, ent))
                start, ent = i, t.rsplit("-", 1)[0]
            elif t.endswith("-cont"):
                continue
            else:
                if start is not None:
                    out.append((start, i, ent))
                    start, ent = None, None
        if start is not None:
            out.append((start, len(tags), ent))
        return out


# --------------------------------------------------------------------- #
# POS tagger (POSTaggerME: perceptron/maxent + optional tag dictionary) #
# --------------------------------------------------------------------- #

def load_tag_dictionary(path: str) -> Dict[str, List[str]]:
    """tags.tagdict XML inside a pos model container: token → allowed
    tags (POSDictionary; constrains the beam for known words)."""
    import xml.etree.ElementTree as ET
    with zipfile.ZipFile(path) as z:
        if "tags.tagdict" not in z.namelist():
            return {}
        root = ET.fromstring(z.read("tags.tagdict"))
    out: Dict[str, List[str]] = {}
    for entry in root.iter("entry"):
        tags = (entry.get("tags") or "").split()
        tok = entry.findtext("token")
        if tok and tags:
            out[tok] = tags
    return out


class POSTagger:
    """POSTaggerME over the shipped perceptron/maxent models: per-token
    eval with prev-tag features ("t=", "t2=") beam-searched; rare-word
    prefix/suffix/shape features mirror POSContextGenerator (recovered
    from the model's own predicate vocabulary: w/p/pp/n/nn, pre/suf 1-4,
    c/d/h, default)."""

    BEAM = 3

    def __init__(self, model: MaxentModel,
                 tagdict: Optional[Dict[str, List[str]]] = None):
        self.model = model
        self.tagdict = tagdict or {}

    @staticmethod
    def _context(tokens: List[str], i: int, prev: str, pprev: str
                 ) -> List[str]:
        # boundary literals from the model's own vocabulary: previous
        # words beyond the start are "*SB*", next words beyond the end
        # "*SE*"; prev-TAG features are simply omitted at the start (the
        # t=/t2= vocab has no bos value)
        n = len(tokens)
        w = tokens[i]
        feats = ["default", "w=" + w]
        feats.append("p=" + (tokens[i - 1] if i > 0 else "*SB*"))
        feats.append("pp=" + (tokens[i - 2] if i > 1 else "*SB*"))
        feats.append("n=" + (tokens[i + 1] if i + 1 < n else "*SE*"))
        feats.append("nn=" + (tokens[i + 2] if i + 2 < n else "*SE*"))
        if prev:
            feats.append("t=" + prev)
            if pprev:
                feats.append("t2=" + pprev + "," + prev)
        for L in (1, 2, 3, 4):
            if len(w) > L:
                feats.append("pre=" + w[:L])
                feats.append("suf=" + w[-L:])
        if any(c.isupper() for c in w):
            feats.append("c")
        if any(c.isdigit() for c in w):
            feats.append("d")
        if "-" in w:
            feats.append("h")
        return feats

    def tag(self, tokens: List[str]) -> List[str]:
        if not tokens:
            return []
        beam: List[Tuple[float, List[str]]] = [(0.0, [])]
        for i, w in enumerate(tokens):
            allowed = set(self.tagdict.get(w, ()))
            nxt: List[Tuple[float, List[str]]] = []
            for score, seq in beam:
                prev = seq[-1] if seq else ""
                pprev = seq[-2] if len(seq) > 1 else ""
                probs = self.model.eval(self._context(tokens, i, prev, pprev))
                # log domain, no probability cutoff: perceptron score
                # gaps can exceed softmax's f64 range, and with a
                # tagdict constraint the allowed tag may hold ~0 mass —
                # it must still be rankable, not dropped
                for oi, p in enumerate(probs):
                    o = self.model.outcomes[oi]
                    if allowed and o not in allowed:
                        continue
                    nxt.append((score + math.log(max(p, 1e-300)),
                                seq + [o]))
            if not nxt:
                # tagdict entry shares no tags with the model's outcome
                # set (custom/corrupt dictionary): fall back to the
                # unconstrained distribution rather than dying
                for score, seq in beam:
                    prev = seq[-1] if seq else ""
                    pprev = seq[-2] if len(seq) > 1 else ""
                    probs = self.model.eval(
                        self._context(tokens, i, prev, pprev))
                    for oi, p in enumerate(probs):
                        nxt.append((score + math.log(max(p, 1e-300)),
                                    seq + [self.model.outcomes[oi]]))
            nxt.sort(key=lambda sp: -sp[0])
            beam = nxt[:self.BEAM]
        return beam[0][1]
