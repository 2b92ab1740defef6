"""Copy of ``deeplearningexamples_tpu/models/tts/text.py``: symbol set +
text→sequence conversion, standard library only.

Compact re-implementation of the reference's text module
(``PyTorch/SpeechSynthesis/Tacotron2/tacotron2/text/``): the 148-symbol
inventory (pad + punctuation + letters + ARPAbet phonemes prefixed with
``@``), english cleaners (lowercase, abbreviation expansion, number
normalization, ASCII transliteration, whitespace collapse), curly-brace
ARPAbet sequences (``{HH AH0 L OW1}``), and optional CMUdict lookup.

Number normalization covers the reference ``numbers.py`` cases without the
inflect dependency: comma removal, $/£ amounts, decimal points, ordinals,
and the year-style two-digit grouping for 1000-3000 ("nineteen oh five").
``unidecode`` here is a practical Latin transliteration (explicit table for
the common special letters + NFKD combining-mark strip), the role of the
vendored ``unidecoder/`` tables. ``CMUDict`` loads the standard cmudict
format and feeds the ARPAbet path (reference ``cmudict.py`` +
``get_arpabet``).
"""

from __future__ import annotations

import re
import unicodedata

__all__ = [
    "symbols", "text_to_sequence", "sequence_to_text", "N_SYMBOLS",
    "normalize_numbers", "unidecode", "CMUDict",
]

_pad = "_"
_punctuation = "!'(),.:;? "
_special = "-"
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

_arpabet_phonemes = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0", "AH1",
    "AH2", "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2", "AY", "AY0",
    "AY1", "AY2", "B", "CH", "D", "DH", "EH", "EH0", "EH1", "EH2", "ER", "ER0",
    "ER1", "ER2", "EY", "EY0", "EY1", "EY2", "F", "G", "HH", "IH", "IH0",
    "IH1", "IH2", "IY", "IY0", "IY1", "IY2", "JH", "K", "L", "M", "N", "NG",
    "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1", "OY2", "P", "R", "S", "SH",
    "T", "TH", "UH", "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2", "V", "W",
    "Y", "Z", "ZH",
]
_arpabet = ["@" + p for p in _arpabet_phonemes]

symbols = [_pad] + list(_special) + list(_punctuation) + list(_letters) + _arpabet
N_SYMBOLS = len(symbols)

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}

_abbreviations = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]
_whitespace_re = re.compile(r"\s+")
_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


# ---------------------------------------------------------------------------
# number normalization (reference tacotron2/text/numbers.py)
# ---------------------------------------------------------------------------

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
          (10 ** 3, "thousand"), (100, "hundred")]
_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + _number_to_words(-n)
    if n < 100:
        return _two_digits(n)
    for scale, word in _SCALE:
        if n >= scale:
            head = _number_to_words(n // scale)
            rest = n % scale
            out = f"{head} {word}"
            if rest:
                out += " " + _number_to_words(rest)
            return out
    return _two_digits(n)


def _ordinal_words(n: int) -> str:
    words = _number_to_words(n)
    head, _, last = words.rpartition(" ") if " " in words else ("", "", words)
    if "-" in last:
        t, _, o = last.partition("-")
        last = t + "-" + _ordinal_words_last(o)
    else:
        last = _ordinal_words_last(last)
    return (head + " " + last).strip()


def _ordinal_words_last(w: str) -> str:
    if w in _ORDINAL_SPECIAL:
        return _ORDINAL_SPECIAL[w]
    if w.endswith("y"):
        return w[:-1] + "ieth"
    return w + "th"


def _expand_dollars(m: re.Match) -> str:
    parts = m.group(1).split(".")
    if len(parts) > 2:
        return m.group(1) + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1].ljust(2, "0")[:2]) if len(parts) > 1 and parts[1] else 0
    d_unit = "dollar" if dollars == 1 else "dollars"
    c_unit = "cent" if cents == 1 else "cents"
    if dollars and cents:
        return (f"{_number_to_words(dollars)} {d_unit}, "
                f"{_number_to_words(cents)} {c_unit}")
    if dollars:
        return f"{_number_to_words(dollars)} {d_unit}"
    if cents:
        return f"{_number_to_words(cents)} {c_unit}"
    return "zero dollars"


def _expand_year(n: int) -> str:
    """Reference _expand_number year rules for 1000 < n < 3000."""
    if n == 2000:
        return "two thousand"
    if 2000 < n < 2010:
        return "two thousand " + _ONES[n % 100]
    if n % 100 == 0:
        return _two_digits(n // 100) + " hundred"
    hi, lo = divmod(n, 100)
    if lo < 10:
        return f"{_two_digits(hi)} oh {_ONES[lo]}" if lo else _two_digits(hi)
    return f"{_two_digits(hi)} {_two_digits(lo)}"


def _expand_number(m: re.Match) -> str:
    n = int(m.group(0))
    if 1000 < n < 3000:
        return _expand_year(n)
    return _number_to_words(n)


def normalize_numbers(text: str) -> str:
    text = re.sub(r"([0-9][0-9\,]+[0-9])", lambda m: m.group(1).replace(",", ""),
                  text)
    text = re.sub(r"£([0-9\.]*[0-9]+)", r"\1 pounds", text)
    text = re.sub(r"\$([0-9\.\,]*[0-9]+)", _expand_dollars, text)
    text = re.sub(r"([0-9]+)\.([0-9]+)",
                  lambda m: f"{m.group(1)} point "
                            f"{' '.join(_ONES[int(d)] for d in m.group(2))}",
                  text)
    text = re.sub(r"[0-9]+(st|nd|rd|th)",
                  lambda m: _ordinal_words(int(m.group(0)[:-2])), text)
    text = re.sub(r"[0-9]+", _expand_number, text)
    return text


# ---------------------------------------------------------------------------
# ASCII transliteration (the role of the vendored unidecoder/ tables)
# ---------------------------------------------------------------------------

_TRANSLIT = {
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE", "ß": "ss", "ð": "d",
    "Ð": "D", "þ": "th", "Þ": "Th", "ø": "o", "Ø": "O", "đ": "d", "Đ": "D",
    "ł": "l", "Ł": "L", "ı": "i", "ĸ": "k", "ŋ": "ng", "Ŋ": "NG",
    "’": "'", "‘": "'", "“": '"', "”": '"', "—": "-", "–": "-", "…": "...",
    "«": '"', "»": '"', "¡": "!", "¿": "?",
}


def unidecode(text: str) -> str:
    out = []
    for ch in text:
        if ord(ch) < 128:
            out.append(ch)
            continue
        if ch in _TRANSLIT:
            out.append(_TRANSLIT[ch])
            continue
        # strip combining marks: é -> e, ñ -> n, ü -> u, ...
        decomp = unicodedata.normalize("NFKD", ch)
        out.append("".join(c for c in decomp if not unicodedata.combining(c)
                           and ord(c) < 128))
    return "".join(out)


# ---------------------------------------------------------------------------
# CMU pronouncing dictionary (reference tacotron2/text/cmudict.py)
# ---------------------------------------------------------------------------

_ALT_RE = re.compile(r"\([0-9]+\)")
_VALID_PHONES = set(_arpabet_phonemes)


class CMUDict:
    """cmudict-format file -> {WORD: [pronunciations]}; ``lookup`` returns
    the ARPAbet strings for a word or None."""

    def __init__(self, path_or_lines, keep_ambiguous: bool = True):
        lines = (open(path_or_lines, encoding="latin-1")
                 if isinstance(path_or_lines, str) else path_or_lines)
        entries: dict[str, list[str]] = {}
        for line in lines:
            if not line or line.startswith(";;;"):
                continue
            parts = line.split("  ")
            if len(parts) != 2:
                continue
            word = _ALT_RE.sub("", parts[0])
            pron = parts[1].strip()
            if all(p in _VALID_PHONES for p in pron.split()):
                entries.setdefault(word, []).append(pron)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries
        if hasattr(lines, "close"):
            lines.close()

    def __len__(self):
        return len(self._entries)

    def lookup(self, word: str) -> list[str] | None:
        return self._entries.get(word.upper())


def english_cleaners(text: str) -> str:
    text = unidecode(text)
    text = text.lower()
    text = normalize_numbers(text)
    for pattern, replacement in _abbreviations:
        text = pattern.sub(replacement, text)
    text = _whitespace_re.sub(" ", text)
    return text


def _symbols_to_ids(text: str) -> list[int]:
    return [_symbol_to_id[c] for c in text if c in _symbol_to_id]


def _arpabet_to_ids(text: str) -> list[int]:
    return [
        _symbol_to_id["@" + p] for p in text.split() if "@" + p in _symbol_to_id
    ]


_word_re = re.compile(r"([a-zA-Z']+)")


def _cleaned_to_ids(text: str, cmudict: "CMUDict | None") -> list[int]:
    if cmudict is None:
        return _symbols_to_ids(text)
    # word-wise CMUdict substitution (reference get_arpabet): known words
    # become phoneme spans, unknown words fall back to letters
    seq: list[int] = []
    for piece in _word_re.split(text):
        prons = cmudict.lookup(piece) if _word_re.fullmatch(piece) else None
        if prons:
            seq.extend(_arpabet_to_ids(prons[0]))
        else:
            seq.extend(_symbols_to_ids(piece))
    return seq


def text_to_sequence(
    text: str, cleaner=english_cleaners, cmudict: "CMUDict | None" = None
) -> list[int]:
    """Text (optionally with {ARPABET} spans) -> symbol id list."""
    seq: list[int] = []
    while text:
        m = _curly_re.match(text)
        if not m:
            seq.extend(_cleaned_to_ids(cleaner(text), cmudict))
            break
        seq.extend(_cleaned_to_ids(cleaner(m.group(1)), cmudict))
        seq.extend(_arpabet_to_ids(m.group(2)))
        text = m.group(3)
    return seq


def sequence_to_text(sequence) -> str:
    out = []
    for i in sequence:
        s = _id_to_symbol.get(int(i), "")
        out.append(f"{{{s[1:]}}}" if s.startswith("@") else s)
    return "".join(out)
