"""The normalizers and pre-tokenizers of a fast-tokenizer ``tokenizer.json``
in plain Python, and the Oniguruma patterns they split by, translated into
Python's ``re``.

The ``tokenizers`` package compiles a ``Regex`` pattern with Oniguruma (Ruby
syntax), whose ``\\p{..}`` classes and Unicode ``\\s``/``\\w``/``\\d`` Python's
``re`` does not share, and the card's machine has neither ``tokenizers`` nor
the ``regex`` package. ``onig_to_re`` rewrites such a pattern for ``re``:
property classes become code-point ranges built from ``unicodedata`` (Python
3.12: Unicode 15.0.0), ``\\s`` is Unicode White_Space (Python's also takes
U+001C-U+001F), ``\\w`` is Letter | Mark | Decimal_Number |
Connector_Punctuation (Python's misses the marks), ``\\d`` is
Decimal_Number; anything it does not translate (possessive quantifiers,
atomic groups, script properties such as ``\\p{Han}``, ``\\G``, POSIX brackets,
class intersections, options other than ``i`` and ``m``) raises ValueError.
``find_matches`` walks the matches as Oniguruma does (an empty match right
after a match is skipped).

A piece of text in flight is ``(text, shift, orig)``: ``shift`` the offset in
the original text of its start as the library counts it (the
``NormalizedString``'s original offset: where the piece's first character
came from once it was cut out of a longer one), ``orig`` each character's
original offset, or None when nothing downstream reads offsets (only
``Metaspace`` with ``prepend_scheme`` "first" does).
"""
from __future__ import annotations

import bisect
import functools
import re
import unicodedata
from typing import Callable, Dict, List, Optional, Tuple

Ranges = List[Tuple[int, int]]
Piece = Tuple[str, int, Optional[List[int]]]
MAX_CP = 0x10FFFF

# Unicode White_Space: Oniguruma's \s and Rust's char::is_whitespace
WHITE_SPACE: Ranges = [(0x09, 0x0D), (0x20, 0x20), (0x85, 0x85),
                       (0xA0, 0xA0), (0x1680, 0x1680), (0x2000, 0x200A),
                       (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F),
                       (0x3000, 0x3000)]
_WS = frozenset(chr(c) for lo, hi in WHITE_SPACE for c in range(lo, hi + 1))

# general categories by their one-letter group, and the long names
# Oniguruma reads (case, spaces, "-" and "_" ignored)
_GROUPS = {"L": "Lu Ll Lt Lm Lo", "LC": "Lu Ll Lt", "M": "Mn Mc Me",
           "N": "Nd Nl No", "P": "Pc Pd Ps Pe Pi Pf Po", "S": "Sm Sc Sk So",
           "Z": "Zs Zl Zp", "C": "Cc Cf Cs Co Cn"}
_LONG = {
    "letter": "L", "casedletter": "LC", "l&": "LC",
    "uppercaseletter": "Lu", "lowercaseletter": "Ll",
    "titlecaseletter": "Lt", "modifierletter": "Lm", "otherletter": "Lo",
    "mark": "M", "combiningmark": "M", "nonspacingmark": "Mn",
    "spacingmark": "Mc", "enclosingmark": "Me", "number": "N",
    "decimalnumber": "Nd", "letternumber": "Nl", "othernumber": "No",
    "punctuation": "P", "connectorpunctuation": "Pc",
    "dashpunctuation": "Pd", "openpunctuation": "Ps",
    "closepunctuation": "Pe", "initialpunctuation": "Pi",
    "finalpunctuation": "Pf", "otherpunctuation": "Po", "symbol": "S",
    "mathsymbol": "Sm", "currencysymbol": "Sc", "modifiersymbol": "Sk",
    "othersymbol": "So", "separator": "Z", "spaceseparator": "Zs",
    "lineseparator": "Zl", "paragraphseparator": "Zp", "other": "C",
    "control": "Cc", "format": "Cf", "surrogate": "Cs", "privateuse": "Co",
    "unassigned": "Cn"}


@functools.lru_cache(maxsize=None)
def _category_ranges() -> Dict[str, Ranges]:
    """Every general category's code points as ranges, read from
    unicodedata once per process."""
    out: Dict[str, Ranges] = {}
    category = unicodedata.category
    prev, start = None, 0
    for cp in range(MAX_CP + 1):
        cat = category(chr(cp))
        if cat != prev:
            if prev is not None:
                out.setdefault(prev, []).append((start, cp - 1))
            prev, start = cat, cp
    out.setdefault(prev, []).append((start, MAX_CP))
    return out


def _union(*sets: Ranges) -> Ranges:
    out: Ranges = []
    for lo, hi in sorted(r for s in sets for r in s):
        if out and lo <= out[-1][1] + 1:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def _complement(ranges: Ranges) -> Ranges:
    out, nxt = [], 0
    for lo, hi in _union(ranges):
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = hi + 1
    if nxt <= MAX_CP:
        out.append((nxt, MAX_CP))
    return out


@functools.lru_cache(maxsize=None)
def categories(*cats: str) -> Ranges:
    """The code points of the general categories ``cats`` (two-letter
    ones, or a group letter such as "L")."""
    table = _category_ranges()
    names = [c for cat in cats for c in _GROUPS.get(cat, cat).split()]
    return _union(*(table.get(c, []) for c in names))


@functools.lru_cache(maxsize=None)
def property_ranges(name: str) -> Ranges:
    """``\\p{name}`` as Oniguruma reads it: a general category, its group,
    their long names, Any, Assigned, ASCII or White_Space. Other properties
    (scripts, blocks, binary properties) raise ValueError."""
    key = re.sub(r"[\s_-]", "", name).lower()
    short = {k.lower(): k for k in (*_GROUPS, *_category_ranges())}
    if key in short:
        return categories(short[key])
    if key in _LONG:
        return categories(_LONG[key])
    if key == "any":
        return [(0, MAX_CP)]
    if key == "assigned":
        return _complement(categories("Cn"))
    if key == "ascii":
        return [(0, 0x7F)]
    if key in ("whitespace", "space"):
        return list(WHITE_SPACE)
    raise ValueError(f"\\p{{{name}}}: only general categories are "
                     f"translated (no scripts, blocks or other properties)")


# Other_Alphabetic characters outside the marks: circled, squared and
# negative Latin capitals and small letters
_ALPHABETIC_SO: Ranges = [(0x24B6, 0x24E9), (0x1F130, 0x1F149),
                          (0x1F150, 0x1F169), (0x1F170, 0x1F189)]


@functools.lru_cache(maxsize=None)
def word_ranges() -> Ranges:
    """Oniguruma's Unicode \\w: Alphabetic (Letter, Letter_Number and the
    alphabetic symbols) | Mark | Decimal_Number | Connector_Punctuation,
    and, from its Latin-1 table, the superscripts and vulgar fractions
    U+00B2, U+00B3, U+00B9 and U+00BC-U+00BE."""
    return _union(categories("L", "Nl", "M", "Nd", "Pc"), _ALPHABETIC_SO,
                  [(0xB2, 0xB3), (0xB9, 0xB9), (0xBC, 0xBE)])


@functools.lru_cache(maxsize=None)
def rust_word_ranges() -> Ranges:
    """Rust's regex crate's Unicode \\w, which the Whitespace pre-tokenizer
    splits by: Alphabetic | Mark | Decimal_Number | Connector_Punctuation |
    Join_Control."""
    return _union(categories("L", "Nl", "M", "Nd", "Pc"), _ALPHABETIC_SO,
                  [(0x200C, 0x200D)])


# case mappings stop below this code point
_CASED_LIMIT = 0x20000


@functools.lru_cache(maxsize=None)
def _fold_groups() -> Dict[int, Tuple[int, ...]]:
    """Code point -> every code point of its simple case-fold class, for
    those whose class has others (a character's one-character fold: its
    casefold, else its lowercase, else itself)."""
    groups: Dict[str, List[int]] = {}
    for cp in range(_CASED_LIMIT):
        c = chr(cp)
        f = c.casefold()
        if len(f) != 1:
            f = c.lower() if len(c.lower()) == 1 else c
        groups.setdefault(f, []).append(cp)
    out: Dict[int, Tuple[int, ...]] = {}
    for cps in groups.values():
        if len(cps) > 1:
            for cp in cps:
                out[cp] = tuple(cps)
    return out


@functools.lru_cache(maxsize=None)
def _multi_folds() -> frozenset:
    """The strings that a character's case fold spells in more than one
    character ("ss" for ß, "st" for the ligature)."""
    return frozenset(chr(c).casefold() for c in _multi_fold_points())


@functools.lru_cache(maxsize=None)
def _multi_fold_points() -> Tuple[int, ...]:
    return tuple(c for c in range(_CASED_LIMIT)
                 if len(chr(c).casefold()) > 1)


def _contains(ranges: Ranges, cp: int) -> bool:
    k = bisect.bisect_right(ranges, (cp, MAX_CP + 1)) - 1
    return k >= 0 and ranges[k][0] <= cp <= ranges[k][1]


def _fold_ranges(ranges: Ranges) -> Ranges:
    """``ranges`` with every member's case-fold class."""
    extra = {m for cp, grp in _fold_groups().items() if _contains(ranges, cp)
             for m in grp}
    return _union(ranges, [(m, m) for m in extra])


_CLASS_ESCAPES: Dict[str, Callable[[], Ranges]] = {
    "s": lambda: list(WHITE_SPACE), "w": word_ranges,
    "d": lambda: categories("Nd"),
    "h": lambda: [(0x30, 0x39), (0x41, 0x46), (0x61, 0x66)]}
_CHAR_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
                 "a": "\a", "e": "\x1b"}
_INTERVAL = re.compile(r"\{(\d*)(,(\d*))?\}")


def _cp(c: int) -> str:
    ch = chr(c)
    return ch if ch.isascii() and ch.isalnum() else f"\\U{c:08x}"


def class_re(ranges: Ranges) -> str:
    """A ``re`` character class for ``ranges`` (one that matches nothing
    when they are empty)."""
    if not ranges:
        return "(?!)"
    return "[" + "".join(_cp(lo) if lo == hi else f"{_cp(lo)}-{_cp(hi)}"
                         for lo, hi in ranges) + "]"


class _Translator:
    """One pass over an Oniguruma (Ruby syntax) pattern, writing ``re``.

    Ignore-case (``(?i)`` at the start, ``(?i:...)``) is written out, never
    left to ``re``: a literal becomes its simple case-fold class and a
    bracket class takes its members' classes before its negation, as
    Oniguruma folds (Python's own folding also lets U+0130 and U+0131 match
    "i"); escapes such as ``\\p{Lu}`` outside brackets are not folded."""

    def __init__(self, pattern: str):
        self.p, self.i, self.out = pattern, 0, []
        # ignore-case per open group (the last: the current scope), and the
        # literal characters in a row under it
        self.icase, self.run_text = [False], ""

    def fail(self, what: str):
        raise ValueError(f"regex {self.p!r}: {what} at offset {self.i} is "
                         f"not translated")

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.p[j] if j < len(self.p) else ""

    def take(self) -> str:
        c = self.peek()
        if not c:
            self.fail("an unfinished construct")
        self.i += 1
        return c

    def braced(self) -> str:
        end = self.p.find("}", self.i)
        if self.peek() != "{" or end < 0:
            self.fail("an escape without its {...}")
        body, self.i = self.p[self.i + 1:end], end + 1
        return body

    def hex_digits(self, n: int) -> int:
        digits = self.p[self.i:self.i + n]
        if len(digits) != n or not all(c in "0123456789abcdefABCDEF"
                                       for c in digits):
            self.fail("a malformed hex escape")
        self.i += n
        return int(digits, 16)

    def literal(self, cp: int):
        """One literal character; under ignore-case its case-fold class.
        A run of them that a multi-character fold could match raises (Python
        has no such folding)."""
        if not self.icase[-1]:
            self.out.append(re.escape(chr(cp)))
            return
        self.run_text += chr(cp)
        folded = self.run_text.casefold()
        if any(m in folded for m in _multi_folds()):
            self.fail("a case-insensitive literal that a multi-character "
                      "fold can match")
        grp = _fold_groups().get(cp)
        self.out.append(class_re(_union([(c, c) for c in grp])) if grp
                        else re.escape(chr(cp)))

    def escape(self, in_class: bool):
        """The escape after a backslash: ("ranges", Ranges), ("char",
        code point) or, outside a class, ("re", text)."""
        e = self.take()
        if e in "pP":
            body = self.braced()
            neg = e == "P"
            if body.startswith("^"):
                neg, body = not neg, body[1:]
            r = property_ranges(body)
            return "ranges", _complement(r) if neg else r
        if e.lower() in _CLASS_ESCAPES:
            r = _CLASS_ESCAPES[e.lower()]()
            return "ranges", _complement(r) if e.isupper() else r
        if e in _CHAR_ESCAPES:
            return "char", ord(_CHAR_ESCAPES[e])
        if e == "x":
            if self.peek() == "{":
                body = self.braced()
                try:
                    return "char", int(body, 16)
                except ValueError:
                    self.fail("a malformed \\x{...}")
            return "char", self.hex_digits(2)
        if e == "u":
            return "char", self.hex_digits(4)
        if e == "0":
            digits = ""
            while len(digits) < 2 and self.peek() in tuple("01234567"):
                digits += self.take()
            return "char", int(digits or "0", 8)
        if not e.isalnum():
            return "char", ord(e)
        if not in_class:
            if e in "Az":
                return "re", "\\A" if e == "A" else "\\Z"
            if e == "Z":
                return "re", "(?=\\n?\\Z)"
            if e in "bB":
                w = class_re(word_ranges())
                at = f"(?:(?<={w})(?!{w})|(?<!{w})(?={w}))"
                return "re", at if e == "b" else f"(?!{at})"
            if self.icase[-1] and (e.isdigit() or e == "k"):
                self.fail("a back-reference under ignore-case")
            if e in "123456789" and not self.peek().isdigit():
                return "re", "\\" + e
            if e == "k" and self.peek() == "<":
                end = self.p.find(">", self.i)
                name, self.i = self.p[self.i + 1:end], end + 1
                if end < 0 or not name.isidentifier():
                    self.fail("a back-reference other than \\k<name>")
                return "re", f"(?P={name})"
        self.i -= 2
        self.fail(f"the escape \\{e}")

    def char_class(self) -> Ranges:
        """A bracket expression, the "[" taken: its members (case-folded
        under ignore-case), then its negation."""
        neg = self.peek() == "^"
        if neg:
            self.i += 1
        if self.peek() == "]":
            self.fail("a class opening with ]")
        sets: List[Ranges] = []
        first = True
        while True:
            c = self.take()
            if c == "]":
                break
            if c == "[":
                if self.peek() == ":":
                    self.fail("a POSIX bracket")
                sets.append(self.char_class())
                first = False
                continue
            if c == "&" and self.peek() == "&":
                self.fail("a class intersection")
            if c == "\\":
                kind, val = self.escape(in_class=True)
                if kind == "ranges":
                    sets.append(val)
                    first = False
                    continue
                lo = val
            else:
                lo = ord(c)
            if c == "-" and not first and self.peek() != "]":
                self.fail("a '-' after a class or range")
            first = False
            if self.peek() == "-" and self.peek(1) not in ("]", ""):
                self.i += 1
                c2 = self.take()
                if c2 == "[":
                    self.fail("a range that ends in a class")
                if c2 == "\\":
                    kind, hi = self.escape(in_class=True)
                    if kind != "char":
                        self.fail("a range that ends in a class")
                else:
                    hi = ord(c2)
                if hi < lo:
                    self.fail("an empty range")
                sets.append([(lo, hi)])
            else:
                sets.append([(lo, lo)])
        r = _union(*sets)
        if self.icase[-1]:
            if any(_contains(r, cp) for cp in _multi_fold_points()):
                self.fail("a case-insensitive class with a character whose "
                          "fold has more than one character")
            r = _fold_ranges(r)
        return _complement(r) if neg else r

    def group(self):
        """What follows "(", the "(" taken."""
        icase = self.icase[-1]
        if self.peek() != "?":
            self.out.append("(")
            self.icase.append(icase)
            return
        self.i += 1
        c = self.peek()
        if c in (":", "=", "!"):
            self.i += 1
            self.out.append("(?" + c)
        elif c == "<" and self.peek(1) in ("=", "!"):
            self.i += 2
            self.out.append("(?<" + self.p[self.i - 1])
        elif c in ("<", "'"):
            end = self.p.find(">" if c == "<" else "'", self.i + 1)
            name = self.p[self.i + 1:end]
            if end < 0 or not name.isidentifier():
                self.fail("a malformed group name")
            self.i = end + 1
            self.out.append(f"(?P<{name}>")
        elif c == "#":
            end = self.p.find(")", self.i)
            if end < 0:
                self.fail("an unfinished comment")
            self.i = end + 1
            return
        else:
            m = re.match(r"([imx]*)(?:-([imx]*))?([:)])", self.p[self.i:])
            if not m or not (m.group(1) or m.group(2)):
                self.fail(f"the group (?{c}")
            on, off, end = m.group(1), m.group(2) or "", m.group(3)
            if "x" in on + off:
                self.fail("the x (extended) option")
            self.i += m.end()
            icase = "i" in on or (icase and "i" not in off)
            if end == ")":
                if self.out or len(self.icase) > 1:
                    self.fail("an option group that is not at the pattern's "
                              "start")
                self.icase[-1] = icase
                if "m" in on:
                    self.out.append("(?s)")
                return
            # Ruby syntax: (?m) lets "." match a newline, Python's (?s)
            on, off = on.replace("i", "").replace("m", "s"), \
                off.replace("i", "").replace("m", "s")
            self.out.append(f"(?{on}{'-' + off if off else ''}:")
        self.icase.append(icase)

    def quantifier_tail(self):
        """After a quantifier: "?" (lazy) is kept, "+" (possessive)
        raises."""
        if self.peek() == "?":
            self.out.append(self.take())
        elif self.peek() == "+":
            self.fail("a possessive quantifier")

    def run(self) -> str:
        while self.i < len(self.p):
            c = self.take()
            run_text, self.run_text = self.run_text, ""
            if c == "\\":
                kind, val = self.escape(in_class=False)
                if kind == "char":
                    self.run_text = run_text
                    self.literal(val)
                else:
                    self.out.append(class_re(val) if kind == "ranges"
                                    else val)
            elif c == "[":
                self.out.append(class_re(self.char_class()))
            elif c == "(":
                self.group()
            elif c == ")":
                if len(self.icase) == 1:
                    self.fail("an unbalanced )")
                self.icase.pop()
                self.out.append(c)
            elif c in "*+?":
                self.out.append(c)
                self.quantifier_tail()
            elif c == "{":
                m = _INTERVAL.match(self.p, self.i - 1)
                if m and (m.group(1) or m.group(3)):
                    self.out.append(m.group())
                    self.i = m.end()
                    self.quantifier_tail()
                else:
                    self.run_text = run_text
                    self.literal(ord(c))
            elif c in ".^$|":
                self.out.append(c)
            else:
                self.run_text = run_text
                self.literal(ord(c))
        return "".join(self.out)


@functools.lru_cache(maxsize=256)
def onig_to_re(pattern: str) -> "re.Pattern":
    """An Oniguruma pattern compiled by ``re`` (``^`` and ``$`` match at
    line ends, as in Ruby syntax). Raises ValueError on what is not
    translated, or what ``re`` then refuses."""
    text = _Translator(pattern).run()
    try:
        return re.compile(text, re.MULTILINE)
    except re.error as e:
        raise ValueError(f"regex {pattern!r}: re refuses its translation "
                         f"({e})") from e


Match = Tuple[int, int, bool]


def find_matches(regex: "re.Pattern", text: str) -> List[Match]:
    """(start, end, is a match) spans covering ``text``, as the library's
    ``Pattern::find_matches`` gives them for an Oniguruma regex: matches
    left to right, an empty match right after the previous match skipped
    (the search moves on one character)."""
    if not text:
        return [(0, 0, False)]
    out: List[Match] = []
    n, prev = len(text), 0
    # re's own walk gives the same matches when none is empty
    for m in regex.finditer(text):
        s, e = m.span()
        if s == e:
            break
        if s > prev:
            out.append((prev, s, False))
        out.append((s, e, True))
        prev = e
    else:
        if prev < n:
            out.append((prev, n, False))
        return out
    out, pos, prev, last = [], 0, 0, -1
    search = regex.search
    while pos <= n:
        m = search(text, pos)
        if m is None:
            break
        s, e = m.span()
        if s == e and e == last:
            pos = e + 1
            continue
        if s > prev:
            out.append((prev, s, False))
        out.append((s, e, True))
        prev = pos = last = e
    if prev < n:
        out.append((prev, n, False))
    return out


def char_matches(pred: Callable[[str], bool], text: str) -> List[Match]:
    """``find_matches`` for a character predicate: each character it holds
    for is a match of its own."""
    if not text:
        return [(0, 0, False)]
    out: List[Match] = []
    prev = 0
    for i, c in enumerate(text):
        if pred(c):
            if prev < i:
                out.append((prev, i, False))
            out.append((i, i + 1, True))
            prev = i + 1
    if prev < len(text):
        out.append((prev, len(text), False))
    return out


BEHAVIORS = ("Removed", "Isolated", "MergedWithPrevious", "MergedWithNext",
             "Contiguous")


def split_spans(matches: List[Match], behavior: str) -> List[Tuple[int, int]]:
    """The spans a split keeps, by ``SplitDelimiterBehavior`` (empty ones
    included; the caller drops them)."""
    if behavior == "Removed":
        return [(s, e) for s, e, m in matches if not m]
    if behavior == "Isolated":
        return [(s, e) for s, e, _ in matches]
    out: List[List[int]] = []
    prev_match = False
    if behavior == "MergedWithNext":
        for s, e, m in reversed(matches):
            if m and not prev_match and out:
                out[-1][0] = s
            else:
                out.append([s, e])
            prev_match = m
        return [(s, e) for s, e in reversed(out)]
    for s, e, m in matches:
        merge = (m == prev_match) if behavior == "Contiguous" else \
            (m and not prev_match) if behavior == "MergedWithPrevious" else \
            None
        if merge is None:
            raise ValueError(f"split behavior {behavior!r} is not one of "
                             f"{BEHAVIORS}")
        if merge and out:
            out[-1][1] = e
        else:
            out.append([s, e])
        prev_match = m
    return [(s, e) for s, e in out]


def cut(piece: Piece, spans) -> List[Piece]:
    """The non-empty slices of ``piece`` at ``spans``."""
    text, shift, orig = piece
    if len(spans) == 1 and spans[0] == (0, len(text)):
        return [piece] if text else []
    if orig is None:
        return [(text[a:b], 0, None) for a, b in spans if b > a]
    return [(text[a:b], orig[a], orig[a:b]) for a, b in spans if b > a]


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table (the ByteLevel alphabet):
    printable Latin-1 bytes map to themselves, the other 68 to U+0100..."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# ------------------------------------------------------- normalizers --- #
Normalizer = Callable[[str, int, Optional[List[int]]],
                      Tuple[str, Optional[List[int]]]]


def is_whitespace(c: str) -> bool:
    return c in _WS


@functools.lru_cache(maxsize=None)
def _composes_after() -> frozenset:
    """Characters with combining class 0 that canonical composition can
    join to what precedes them (the second half of a pair whose first is
    a starter, Hangul vowels and trailing consonants)."""
    out = set(chr(c) for c in range(0x1161, 0x1176))
    out.update(chr(c) for c in range(0x11A8, 0x11C3))
    for cp in range(MAX_CP + 1):
        d = unicodedata.decomposition(chr(cp))
        if d and not d.startswith("<"):
            parts = d.split()
            if len(parts) == 2:
                second = chr(int(parts[1], 16))
                if unicodedata.combining(second) == 0:
                    out.add(second)
    return frozenset(out)


@functools.lru_cache(maxsize=65536)
def _starts_chunk(c: str, form: str) -> bool:
    """Whether ``c`` normalizes apart from what precedes it under ``form``:
    its decomposition starts with a starter that composes with nothing
    before it."""
    d = unicodedata.normalize("NFKD" if form.startswith("NFK") else "NFD", c)
    return unicodedata.combining(d[0]) == 0 and d[0] not in _composes_after()


def _unicode_form(form: str) -> Normalizer:
    """NFC / NFD / NFKC / NFKD. Offsets: each output character takes the
    offset of the first character of the run it came from (a starter and
    what composes or reorders with it)."""
    def normalize(text, shift, orig):
        out = unicodedata.normalize(form, text)
        if orig is None or out == text:
            return out, orig
        chunks, parts = [], []
        for i, c in enumerate(text):
            if not chunks or _starts_chunk(c, form):
                chunks.append(i)
        chunks.append(len(text))
        new_orig: List[int] = []
        for a, b in zip(chunks, chunks[1:]):
            part = unicodedata.normalize(form, text[a:b])
            parts.append(part)
            new_orig.extend([orig[a]] * len(part))
        if "".join(parts) != out:           # a run that crossed a chunk
            return out, [orig[0]] * len(out)
        return out, new_orig
    return normalize


def _lowercase(text, shift, orig):
    if text.isascii():
        return text.lower(), orig
    parts = [c.lower() for c in text]      # per character: no final sigma
    out = "".join(parts)
    if orig is None or len(out) == len(text):
        return out, orig
    return out, [o for p, o in zip(parts, orig) for _ in p]


def _strip(left: bool, right: bool) -> Normalizer:
    def strip(text, shift, orig):
        a, b = 0, len(text)
        while left and a < b and text[a] in _WS:
            a += 1
        while right and b > a and text[b - 1] in _WS:
            b -= 1
        return text[a:b], None if orig is None else orig[a:b]
    return strip


def _strip_accents(text, shift, orig):
    keep = [i for i, c in enumerate(text)
            if not unicodedata.category(c).startswith("M")]
    if len(keep) == len(text):
        return text, orig
    return "".join(text[i] for i in keep), \
        None if orig is None else [orig[i] for i in keep]


def _prepend(pre: str) -> Normalizer:
    def prepend(text, shift, orig):
        if not text:
            return text, orig
        return pre + text, None if orig is None else \
            [orig[0]] * len(pre) + orig
    return prepend


def replacer(regex: "re.Pattern", content: str) -> Callable[[str], str]:
    """text -> text with every match (found as the library finds them)
    replaced by ``content``: the Replace decoder's step on one token."""
    return lambda text: _replace(regex, content)(text, 0, None)[0]


def _replace(regex: "re.Pattern", content: str) -> Normalizer:
    """Every match replaced by ``content``, whose characters take the
    offset of the match's last character."""
    def replace(text, shift, orig):
        parts, new_orig = [], []
        for s, e, is_match in find_matches(regex, text):
            if not is_match:
                parts.append(text[s:e])
                if orig is not None:
                    new_orig.extend(orig[s:e])
            else:
                parts.append(content)
                if orig is not None:
                    at = orig[e - 1] if e else shift
                    new_orig.extend([at] * len(content))
        return "".join(parts), None if orig is None else new_orig
    return replace


def pattern_regex(spec: dict, where: str) -> "re.Pattern":
    """A ``pattern`` field: ``{"String": s}`` (matched literally) or
    ``{"Regex": r}`` (Oniguruma, translated)."""
    pat = spec["pattern"]
    if "String" in pat:
        return re.compile(re.escape(pat["String"]))
    if "Regex" in pat:
        try:
            return onig_to_re(pat["Regex"])
        except ValueError as e:
            raise ValueError(f"{where}: {e}") from e
    raise ValueError(f"{where}: pattern {pat} is neither a String nor a "
                     f"Regex")


NORMALIZERS = ("NFC", "NFD", "NFKC", "NFKD", "Lowercase", "Strip",
               "StripAccents", "Prepend", "Replace", "Sequence")


def normalizer(spec: Optional[dict], where: str) -> Optional[Normalizer]:
    """The normalizer of a ``tokenizer.json`` as one function over (text,
    shift, offsets), or None."""
    if spec is None:
        return None
    parts = spec["normalizers"] if spec["type"] == "Sequence" else [spec]
    steps: List[Normalizer] = []
    for p in parts:
        kind = p["type"]
        if kind in ("NFC", "NFD", "NFKC", "NFKD"):
            steps.append(_unicode_form(kind))
        elif kind == "Lowercase":
            steps.append(_lowercase)
        elif kind == "Strip":
            steps.append(_strip(p.get("strip_left", True),
                                p.get("strip_right", True)))
        elif kind == "StripAccents":
            steps.append(_strip_accents)
        elif kind == "Prepend":
            steps.append(_prepend(p["prepend"]))
        elif kind == "Replace":
            steps.append(_replace(pattern_regex(p, where), p["content"]))
        elif kind == "Sequence":
            steps.append(normalizer(p, where))
        else:
            raise ValueError(f"{where}: normalizer {kind} is not read "
                             f"({', '.join(NORMALIZERS)})")

    def normalize(text, shift, orig):
        for step in steps:
            text, orig = step(text, shift, orig)
        return text, orig
    return normalize


# ---------------------------------------------------- pre-tokenizers --- #
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


@functools.lru_cache(maxsize=65536)
def _char_class(c: str) -> str:
    """'s' (whitespace), 'L' (letter), 'N' (number) or 'P' (anything else),
    as the split regex's \\s, \\p{L} and \\p{N} read it (\\s: Unicode
    White_Space; str.isspace also takes U+001C..U+001F, which the regex
    reads as punctuation)."""
    if c in _WS:
        return "s"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "P"


def gpt2_split(text: str) -> List[str]:
    """The ByteLevel pre-tokenizer's split (use_regex, no prefix space):
    the pieces the pattern
      's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+
    matches, left to right, its alternatives tried in order."""
    n = len(text)
    cls = [_char_class(c) for c in text]
    out = []
    i = 0
    while i < n:
        c = text[i]
        if c == "'":
            hit = next((w for w in _CONTRACTIONS
                        if text.startswith(w, i + 1)), None)
            if hit is not None:
                out.append(text[i:i + 1 + len(hit)])
                i += 1 + len(hit)
                continue
        # ` ?X+` for X in letters, numbers, other: an optional U+0020, then a
        # run of one class
        j = i + 1 if c == " " and i + 1 < n and cls[i + 1] != "s" else i
        k = cls[j] if j < n else "s"
        if k != "s":
            e = j + 1
            while e < n and cls[e] == k:
                e += 1
            out.append(text[i:e])
            i = e
            continue
        # whitespace: \s+(?!\S) keeps the run's last character for the next
        # piece when a non-space follows; a lone one falls to \s+
        e = i + 1
        while e < n and cls[e] == "s":
            e += 1
        if e < n and e - i > 1:
            e -= 1
        out.append(text[i:e])
        i = e
    return out


PreTokenizer = Callable[[List[Piece]], List[Piece]]


def _is_numeric(c: str) -> bool:
    """Rust's char::is_numeric: Nd, Nl or No."""
    return unicodedata.category(c) in ("Nd", "Nl", "No")


def _is_punctuation(c: str) -> bool:
    """The Punctuation pre-tokenizer's test: ASCII punctuation or a
    character of a P category."""
    return (c.isascii() and not c.isalnum() and 0x21 <= ord(c) <= 0x7E) \
        or unicodedata.category(c).startswith("P")


def _splitter(find: Callable[[str], List[Match]],
              behavior: str) -> PreTokenizer:
    split_spans([], behavior)                     # checks the name
    return lambda pieces: [q for p in pieces
                           for q in cut(p, split_spans(find(p[0]),
                                                       behavior))]


def _byte_level(add_prefix_space: bool, use_regex: bool) -> PreTokenizer:
    """ByteLevel: a space before a piece that has none (add_prefix_space),
    the GPT-2 split (use_regex), then each character as its UTF-8 bytes'
    characters of the byte alphabet."""
    table = bytes_to_unicode()

    @functools.lru_cache(maxsize=65536)
    def to_bytes(word: str) -> str:
        return "".join(map(table.__getitem__, word.encode("utf-8")))

    def run(pieces):
        out = []
        for text, shift, orig in pieces:
            if not text:
                continue
            if add_prefix_space and not text.startswith(" "):
                text = " " + text
                if orig is not None:
                    orig = orig[:1] + orig
            words = gpt2_split(text) if use_regex else [text]
            at = 0
            for w in words:
                mapped = to_bytes(w)
                if orig is None:
                    out.append((mapped, 0, None))
                else:
                    o = [orig[at + k] for k, c in enumerate(w)
                         for _ in c.encode("utf-8")]
                    out.append((mapped, o[0], o))
                at += len(w)
        return out
    return run


def _metaspace(rep: str, scheme: str, split: bool) -> PreTokenizer:
    """Metaspace: spaces become ``rep``; ``rep`` goes before a piece that
    does not start with it (always, or for "first" only before the piece
    at the text's start); then a split before every ``rep``."""
    def run(pieces):
        out = []
        for text, shift, orig in pieces:
            if not text:
                continue
            text = text.replace(" ", rep)
            if not text.startswith(rep) and (
                    scheme == "always" or (scheme == "first"
                                           and shift == 0)):
                text = rep + text
                if orig is not None:
                    orig = orig[:1] + orig
            piece = (text, shift, orig)
            if split:
                out.extend(cut(piece, split_spans(
                    char_matches(lambda c: c == rep, text),
                    "MergedWithNext")))
            elif text:
                out.append(piece)
        return out
    return run


PRE_TOKENIZERS = ("ByteLevel", "Whitespace", "WhitespaceSplit", "Metaspace",
                  "Split", "Digits", "Punctuation", "Sequence")


def pre_tokenizer(spec: Optional[dict], where: str) -> PreTokenizer:
    """The pre-tokenizer of a ``tokenizer.json`` as one function over a
    list of pieces."""
    if spec is None:
        return lambda pieces: [p for p in pieces if p[0]]
    kind = spec["type"]
    if kind == "Sequence":
        steps = [pre_tokenizer(p, where) for p in spec["pretokenizers"]]

        def sequence(pieces):
            for step in steps:
                pieces = step(pieces)
            return pieces
        return sequence
    if kind == "ByteLevel":
        return _byte_level(bool(spec.get("add_prefix_space")),
                           spec.get("use_regex", True))
    if kind == "Whitespace":
        # Rust's regex crate's \w+|[^\w\s]+
        word = rust_word_ranges()
        regex = re.compile(f"{class_re(word)}+|"
                           f"{class_re(_complement(_union(word, WHITE_SPACE)))}+")
        return _splitter(lambda t: [(s, e, not m) for s, e, m in
                                    find_matches(regex, t)], "Removed")
    if kind == "WhitespaceSplit":
        return _splitter(lambda t: char_matches(is_whitespace, t), "Removed")
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme") or (
            "always" if spec.get("add_prefix_space", True) else "never")
        return _metaspace(rep, scheme, spec.get("split", True))
    if kind == "Split":
        regex = pattern_regex(spec, where)
        invert = bool(spec.get("invert"))
        behavior = spec["behavior"]
        if behavior not in BEHAVIORS:
            raise ValueError(f"{where}: Split behavior {behavior} is not "
                             f"one of {BEHAVIORS}")
        return _splitter(lambda t: [(s, e, m != invert) for s, e, m in
                                    find_matches(regex, t)], behavior)
    if kind == "Digits":
        behavior = "Isolated" if spec.get("individual_digits") \
            else "Contiguous"
        return _splitter(lambda t: char_matches(_is_numeric, t), behavior)
    if kind == "Punctuation":
        behavior = spec.get("behavior", "Isolated")
        if behavior not in BEHAVIORS:
            raise ValueError(f"{where}: Punctuation behavior {behavior} is "
                             f"not one of {BEHAVIORS}")
        return _splitter(lambda t: char_matches(_is_punctuation, t),
                         behavior)
    raise ValueError(f"{where}: pre-tokenizer {kind} is not read "
                     f"({', '.join(PRE_TOKENIZERS)})")


def reads_offsets(spec: Optional[dict]) -> bool:
    """Whether a pre-tokenizer spec holds a Metaspace with prepend_scheme
    "first", the one part that reads where a piece came from."""
    if spec is None:
        return False
    if spec["type"] == "Sequence":
        return any(reads_offsets(p) for p in spec["pretokenizers"])
    return spec["type"] == "Metaspace" and (
        spec.get("prepend_scheme") == "first")


def metaspace_decode(rep: str, scheme: str) -> Callable[[List[str]],
                                                        List[str]]:
    """The Metaspace decoder: ``rep`` becomes a space, except in the first
    token unless the scheme is "never", where it is dropped."""
    def decode(toks):
        return [t.replace(rep, "" if i == 0 and scheme != "never" else " ")
                for i, t in enumerate(toks)]
    return decode
