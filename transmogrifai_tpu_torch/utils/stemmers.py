"""Light per-language suffix stemmers (Snowball-style).

The port's copy of the JAX package's `utils/stemmers.py`, unchanged in
its rules (pure Python; the tokenizer's language modes must stem the
same way in both packages).

Reference parity: the reference's `TextTokenizer` sits on Lucene
analyzers whose per-language stemmers collapse inflectional variants
before hashing/counting (`core/.../utils/text/LuceneTextAnalyzer.scala:87`
— ~30 language analyzers). Without stemming, "run" and "running" hash to
different buckets and SmartTextVectorizer's per-bucket statistics are
measurably noisier on inflected text.

These are LIGHT stemmers in the Savoy/Snowball-light tradition:
ordered longest-first suffix stripping with a minimum-stem guard, plus
two language-specific touches (English -ed/-ing vowel condition and
consonant undoubling, Dutch gemination undoubling). The goal is the
vectorizer's goal — map a word's inflectional family to ONE stable
form — not lemmatization; over-stemmed forms are fine as long as they
are consistent. Languages: en fr de es it pt nl sv da no ru (the top
Latin-script set + Russian). `stem()` is identity for anything else,
so CJK/Thai bigram tokens and unknown languages pass through unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["stem", "stem_tokens", "SUPPORTED"]

_VOWELS = "aeiouyàâäáãåéèêëíìîïóòôöõúùûüýæøœαеёиоуыэюяі"


def _has_vowel(s: str) -> bool:
    return any(c in _VOWELS for c in s)


def _strip_ordered(word: str, suffixes: Tuple[str, ...],
                   min_stem: int, min_single: Optional[int] = None) -> str:
    """Remove the FIRST (longest-first-ordered) matching suffix leaving
    at least `min_stem` chars (`min_single` for 1-char suffixes — e.g.
    German final -s must not clip "haus"); one removal only — light
    stemming."""
    for suf in suffixes:
        need = min_stem if len(suf) > 1 else (min_single or min_stem)
        if word.endswith(suf) and len(word) - len(suf) >= need:
            return word[:-len(suf)]
    return word


def _stem_en(w: str) -> str:
    # plural / 3rd person (Porter step 1a)
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies") and len(w) > 4:
        w = w[:-2]
    elif w.endswith("s") and not w.endswith(("ss", "us", "is")) \
            and len(w) > 3:
        w = w[:-1]
    # -ed / -ing with the Porter vowel condition + undoubling
    for suf in ("ingly", "edly", "ing", "ed"):
        if w.endswith(suf) and len(w) - len(suf) >= 2:
            stem = w[:-len(suf)]
            if _has_vowel(stem):
                if (len(stem) >= 3 and stem[-1] == stem[-2]
                        and stem[-1] not in "lsz"):
                    stem = stem[:-1]           # running → run
                elif stem.endswith(("at", "bl", "iz")):
                    stem += "e"                # conflated → conflate
                w = stem
            break
    # terminal y → i (Porter 1c): happy/happiness and family/families
    # land on one form
    if w.endswith("y") and len(w) > 3 and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # common derivational tails (guarded: station keeps its t-i-o-n)
    w = _strip_ordered(w, ("fulness", "ousness", "iveness", "ization",
                           "ational", "biliti", "ality", "ivity",
                           "ment", "ness", "ful"), 4)
    # -ly/-li only after Porter2's valid-li letters (quickli → quick,
    # but famili keeps its li)
    if w.endswith(("ly", "li")) and len(w) > 5 and w[-3] in "cdeghkmnrt":
        w = w[:-2]
    return w


_RULES: Dict[str, Tuple[int, Tuple[str, ...]]] = {
    # lang: (min_stem, longest-first suffix list)
    "fr": (3, ("issements", "issement", "issantes", "issante", "issants",
               "issant", "atrices", "atrice", "ateurs", "ateur",
               "eraient", "iraient", "eaient", "erions", "assent",
               "eront", "ements", "ation", "ution", "ement", "euses",
               "euse", "ables", "able", "istes", "iste", "ives", "ive",
               "ités", "ité", "eaux", "eau", "aux", "erez", "irez",
               "erai", "irai", "erait", "irait", "eait", "eons", "eant",
               "aient", "antes", "ante", "ants", "ant", "ions", "ons",
               "ait", "ent", "ées", "ée", "és", "é", "er", "ez", "es",
               "e", "s", "x")),
    "de": (3, ("ungen", "heiten", "keiten", "lichen", "ischen", "isches",
               "ung", "heit", "keit", "lich", "isch", "erin", "ern",
               "est", "em", "en", "er", "es", "st", "e", "s", "n",
               "t")),
    "es": (3, ("amientos", "imientos", "amiento", "imiento", "aciones",
               "uciones", "ación", "ución", "adoras", "adores", "adora",
               "ador", "ancias", "ancia", "ísimas", "ísimos", "ísima",
               "ísimo", "áramos", "iéramos", "aremos", "eremos",
               "iremos", "ábamos", "íamos", "amente", "mente", "ieron",
               "iendo", "aron", "ando", "adas", "ados", "idas", "idos",
               "aban", "aba", "abas", "ada", "ado", "ida", "ido",
               "ará", "arán", "aré", "ían", "ías", "ía", "ar", "er",
               "ir", "es", "s", "e")),
    "it": (3, ("azioni", "azione", "amenti", "amento", "imenti",
               "imento", "mente", "ando", "endo", "ato", "ata", "ati",
               "ate", "uto", "uta", "uti", "ute", "are", "ere", "ire",
               "i", "e", "a", "o", "à", "ò", "ù")),
    "pt": (3, ("amentos", "imentos", "amento", "imento", "adores",
               "ações", "ação", "ador", "ando", "endo", "indo", "ados",
               "adas", "idos", "idas", "aram", "eram", "iram", "ado",
               "ada", "ido", "ida", "ou", "ar", "er", "ir", "ões",
               "ão", "os", "as", "es", "s", "e", "a", "o")),
    "sv": (2, ("heterna", "heten", "arna", "orna", "erna", "ande",
               "ende", "aste", "are", "ast", "ar", "or", "er", "en",
               "et", "na", "a", "e", "s")),
    "da": (2, ("erne", "ede", "ende", "erer", "er", "en", "et", "e",
               "s")),
    "no": (2, ("ene", "ane", "ede", "ende", "er", "en", "et", "a", "e",
               "s")),
}

# Russian gets a fuller, carefully ordered list — defined separately
# for readability (Snowball Russian endings, light subset, ordered
# longest-first; stripping happens once)
_RULES["ru"] = (3, (
    "ировала", "ировать", "ившись", "ывшись", "вшись", "ивши", "ывши",
    "ениями", "ениях", "ением", "ения", "ении", "ение",
    "остью", "ости", "ость",
    "ейшие", "ейший", "ейшая", "ейшее",
    "иями", "ями", "ами", "иях", "ях", "ах",
    "ется", "ится", "ться", "тся",
    "аете", "уете", "ите", "ете",
    "ола", "ыла", "ила", "ело", "ыло", "ило", "ала", "яла",
    "али", "яли", "ыли", "или",
    "ует", "ют", "ат", "ят", "ет", "ит",
    "ого", "его", "ому", "ему", "ыми", "ими",
    "ая", "яя", "ое", "ее", "ые", "ие", "ый", "ий", "ой", "ую", "юю",
    "ою", "ею", "ем", "им", "ым", "ом", "их", "ых", "ей",
    "иям", "ям", "ам", "ию", "ью", "ия", "ья",
    "ов", "ев",
    "а", "е", "и", "й", "о", "у", "ы", "ь", "ю", "я",
))

# Dutch: strip, then undouble BOTH geminated consonants (katten → katt
# → kat) and the open-syllable long vowel (lopen → lop, loopt → loop →
# lop), so the vowel-alternating paradigm lands on one form
_NL_SUFFIXES = ("heden", "ingen", "tjes", "pjes", "jes", "ing", "en",
                "je", "st", "s", "e", "t")


def _stem_nl(w: str) -> str:
    out = _strip_ordered(w, _NL_SUFFIXES, 3)
    if out is not w and len(out) >= 3 and out[-1] == out[-2]:
        out = out[:-1]
    elif (out is not w and len(out) >= 4 and out[-2] == out[-3]
          and out[-2] in "aeou" and out[-1] not in _VOWELS):
        out = out[:-3] + out[-2] + out[-1]  # loop → lop
    return out


# 1-char suffixes need a longer remaining stem in languages where short
# content words end in those letters (German haus, nouns in -t/-n)
_MIN_SINGLE = {"de": 4, "fr": 4, "sv": 3, "da": 3, "no": 3}

_ACUTE_FOLD = str.maketrans("áéíóúâêô", "aeiouaeo")

SUPPORTED = frozenset(_RULES) | {"en", "nl"}


def stem(word: str, lang: Optional[str]) -> str:
    """Stemmed form of one (already lowercased) token; identity for
    unsupported languages and very short tokens."""
    if not word or len(word) <= 3 or lang is None:
        return word
    if lang == "en":
        return _stem_en(word)
    if lang == "nl":
        return _stem_nl(word)
    rule = _RULES.get(lang)
    if rule is None:
        return word
    out = _strip_ordered(word, rule[1], rule[0],
                         min_single=_MIN_SINGLE.get(lang))
    if lang in ("es", "pt", "it"):
        # Snowball's final step: fold acute accents so singular/plural
        # accent alternations (jardín/jardines) land on one stem
        out = out.translate(_ACUTE_FOLD)
    return out


def stem_tokens(tokens: List[str], lang: Optional[str]) -> List[str]:
    if lang not in SUPPORTED:
        return tokens
    return [stem(t, lang) for t in tokens]
