"""Regex transpiler: Java-regex subset -> byte-class DFA tables.

Host-only copy of `spark_rapids_tpu/regex/transpiler.py` (numpy, no
device code): the port's compiled tables equal the reference's for every
pattern. `_conf_limit` reads the port's active session.

The reference transpiles Java regexes to the cuDF regex dialect
(`RegexParser.scala`, 2,009 LoC) because device regex must agree with
Spark's Java semantics; unsupported constructs fall back to CPU with a
tagging reason, bounded by `RegexComplexityEstimator.scala`.

The approach is compile-time heavier and run-time simpler: parse the
(common Java/cuDF/Python) regex subset into an AST, build a Thompson
NFA, and determinize to a DFA over **byte equivalence classes**; then
matching is a dense table walk, one table read per byte of each row
(kernel K18, ops/regexops.py).

Search (Spark RLIKE / Matcher.find) semantics are compiled in: a
self-loop on the start state unless the pattern starts with `^`, and
absorbing accept states unless it ends with `$`.

Dialect coverage: per-branch anchors with Java binding ("^a|b"
anchors only the first branch), nested class unions [a[b-c]] and
intersections [a-z&&[^aeiou]], octal (backslash-0n), hex
(backslash-xhh), backslash-uXXXX (ASCII), and backslash-cX control
escapes. A complexity estimator
(`estimate_states`, the RegexComplexityEstimator role) predicts NFA
blowup from nested bounded repeats and tags CPU fallback BEFORE paying
construction; MAX_STATES on the DFA remains the hard backstop.

Unsupported (-> RegexUnsupported, operator falls back to CPU):
backreferences, lookaround, lazy/possessive quantifiers beyond syntax
acceptance, inline flags, named groups, unicode classes, and DFAs larger
than MAX_STATES. Matching is byte-oriented (UTF-8): multi-byte
characters match `.`/negated classes per byte — same caveat class as the
cuDF dialect differences documented by the reference.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.config import rapids_conf as _rc

#: single source of truth: the conf defaults
#: (spark.rapids.sql.regexp.maxStates / .complexityLimit)
MAX_STATES = _rc.REGEX_MAX_STATES.default
COMPLEXITY_LIMIT = _rc.REGEX_COMPLEXITY_LIMIT.default
MAX_REPEAT = 64


def _conf_limit(entry, loose: bool) -> int:
    """Read a limit from the ACTIVE session's conf (the transpiler is
    session-free; same active-session read as the string-ceiling and
    ANSI checks — a pattern compiled while a DIFFERENT session is
    active sees that session's limits). `loose=True` returns
    max(session value, default): the CPU rlike path compiles with the
    LOOSER bound so neither tightening nor raising the DEVICE resource
    knobs shifts CPU evaluation off the Java-semantics DFA onto
    Python re."""
    v = int(entry.default)
    from spark_rapids_tpu_torch.api.session import TpuSparkSession

    s = TpuSparkSession.active()
    if s is not None:
        sv = int(s.rapids_conf.get(entry))
        v = max(sv, v) if loose else sv
    return v


class RegexUnsupported(Exception):
    """Pattern outside the transpilable subset (CPU fallback reason)."""


# ------------------------------------------------------------------- AST

class _Node:
    pass


class _Chars(_Node):
    """One byte-set."""

    def __init__(self, mask: np.ndarray):
        self.mask = mask  # [256] bool


class _Concat(_Node):
    def __init__(self, parts: List[_Node]):
        self.parts = parts


class _Alt(_Node):
    def __init__(self, options: List[_Node]):
        self.options = options


class _Repeat(_Node):
    def __init__(self, child: _Node, lo: int, hi: Optional[int]):
        self.child = child
        self.lo = lo
        self.hi = hi  # None = unbounded


def _mask_of(*ranges, chars=""):
    m = np.zeros(256, dtype=bool)
    for lo, hi in ranges:
        m[lo:hi + 1] = True
    for c in chars:
        m[ord(c)] = True
    return m


_DIGIT = _mask_of((ord("0"), ord("9")))
_WORD = _mask_of((ord("a"), ord("z")), (ord("A"), ord("Z")),
                 (ord("0"), ord("9")), chars="_")
_SPACE = _mask_of(chars=" \t\n\x0b\f\r")
_DOT = ~_mask_of(chars="\n")  # Java default: . matches all but \n
_ANY = np.ones(256, dtype=bool)

_ESCAPES = {
    "d": _DIGIT, "D": ~_DIGIT, "w": _WORD, "W": ~_WORD,
    "s": _SPACE, "S": ~_SPACE,
}
_CTRL = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "a": "\x07",
         "e": "\x1b"}


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg):
        raise RegexUnsupported(f"{msg} at {self.i} in {self.p!r}")

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse_branches(self) -> List[Tuple[_Node, bool, bool]]:
        """Top-level alternation with JAVA anchor binding: anchors
        attach per branch ("^a|b" anchors only the first branch).
        -> [(node, anchored_start, anchored_end)]."""
        branches: List[Tuple[_Node, bool, bool]] = []
        while True:
            a_start = False
            if self.peek() == "^":
                a_start = True
                self.take()
            self._branch_end = False
            node = self.concat(top=True)
            branches.append((node, a_start, self._branch_end))
            if self.peek() == "|":
                self.take()
                continue
            break
        if self.i < len(self.p):
            self.error("unexpected trailing input")
        return branches

    def alt(self) -> _Node:
        options = [self.concat()]
        while self.peek() == "|":
            self.take()
            options.append(self.concat())
        return options[0] if len(options) == 1 else _Alt(options)

    def concat(self, top=False) -> _Node:
        parts: List[_Node] = []
        while True:
            c = self.peek()
            if c is None or c in "|)":
                break
            if c == "$":
                # supported at the end of a TOP-LEVEL branch
                nxt = (self.p[self.i + 1]
                       if self.i + 1 < len(self.p) else None)
                if top and nxt in (None, "|"):
                    self._branch_end = True
                    self.take()
                    break
                self.error("'$' only supported at branch end")
            parts.append(self.repeat())
        if not parts:
            return _Concat([])
        return parts[0] if len(parts) == 1 else _Concat(parts)

    def repeat(self) -> _Node:
        atom = self.atom()
        c = self.peek()
        if c not in ("*", "+", "?", "{"):
            return atom
        if c == "{":
            save = self.i
            self.take()
            lo, hi = self._braces(save)
        else:
            self.take()
            lo, hi = {"*": (0, None), "+": (1, None), "?": (0, 1)}[c]
        # lazy / possessive suffixes: match-only semantics are identical
        if self.peek() == "?":
            self.take()
        elif self.peek() == "+":
            self.error("possessive quantifiers unsupported")
        return _Repeat(atom, lo, hi)

    def _braces(self, save) -> Tuple[int, Optional[int]]:
        digits = ""
        while self.peek() and self.peek().isdigit():
            digits += self.take()
        if not digits:
            self.error("bad {m,n}")
        lo = int(digits)
        hi: Optional[int] = lo
        if self.peek() == ",":
            self.take()
            digits = ""
            while self.peek() and self.peek().isdigit():
                digits += self.take()
            hi = int(digits) if digits else None
        if self.peek() != "}":
            self.error("bad {m,n}")
        self.take()
        if hi is not None and hi < lo:
            self.error("bad repeat range")
        if (hi or lo) > MAX_REPEAT:
            raise RegexUnsupported(
                f"repeat bound > {MAX_REPEAT} in {self.p!r}")
        return lo, hi

    def atom(self) -> _Node:
        c = self.take()
        if c == "(":
            if self.peek() == "?":
                self.take()
                nxt = self.peek()
                if nxt == ":":
                    self.take()
                else:
                    self.error("only (?:...) groups supported")
            node = self.alt()
            if self.peek() != ")":
                self.error("unbalanced group")
            self.take()
            return node
        if c == "[":
            return _Chars(self._char_class())
        if c == ".":
            return _Chars(_DOT.copy())
        if c == "\\":
            return _Chars(self._escape())
        if c in "*+?{":
            self.error(f"dangling quantifier {c!r}")
        if c == "^":
            self.error("'^' only supported at pattern start")
        b = c.encode("utf-8")
        if len(b) == 1:
            return _Chars(_mask_of(chars=c))
        # multi-byte literal char: byte sequence
        return _Concat([_Chars(_mask_of((x, x))) for x in b])

    def _escape(self) -> np.ndarray:
        c = self.peek()
        if c is None:
            self.error("trailing backslash")
        self.take()
        if c in _ESCAPES:
            return _ESCAPES[c].copy()
        if c in _CTRL:
            return _mask_of(chars=_CTRL[c])
        if c == "x":
            h = self.p[self.i:self.i + 2]
            if len(h) != 2 or not all(x in "0123456789abcdefABCDEF"
                                      for x in h):
                self.error("bad \\x escape")
            self.i += 2
            return _mask_of((int(h, 16), int(h, 16)))
        if c == "0":
            # Java octal: \0n, \0nn, \0mnn
            digits = ""
            while (len(digits) < 3 and self.peek()
                   and self.peek() in "01234567"):
                digits += self.take()
            if not digits:
                self.error("bad octal escape")
            v = int(digits, 8)
            if v > 255:
                self.error("octal escape > 0377")
            return _mask_of((v, v))
        if c == "u":
            h = self.p[self.i:self.i + 4]
            if len(h) != 4 or not all(x in "0123456789abcdefABCDEF"
                                      for x in h):
                self.error("bad \\u escape")
            self.i += 4
            v = int(h, 16)
            if v > 127:
                raise RegexUnsupported(
                    "non-ASCII \\u escape (byte-oriented matcher)")
            return _mask_of((v, v))
        if c == "c":
            # Java control-char escape: ANY next char is accepted and
            # XORed raw (Pattern.java `read() ^ 64`) — no uppercasing,
            # so `\cj` is 0x6A^0x40 = 0x2A ('*'), not Ctrl-J
            ch = self.peek()
            if ch is None:
                self.error("bad \\c escape")
            self.take()
            v = ord(ch) ^ 0x40
            if v > 127:
                # same stance as non-ASCII \u: the matcher is
                # byte-oriented, a >7-bit code point is not one byte
                raise RegexUnsupported(
                    "non-ASCII \\c escape (byte-oriented matcher)")
            return _mask_of((v, v))
        if c.isdigit():
            raise RegexUnsupported(f"backreference \\{c} in {self.p!r}")
        if c.isalpha():
            raise RegexUnsupported(f"escape \\{c} unsupported")
        return _mask_of(chars=c)  # escaped metachar

    def _char_class(self) -> np.ndarray:
        """Java character class incl. nested unions [a[b-c]] and
        intersections [a-z&&[^aeiou]]; '^' negates the WHOLE class."""
        negate = False
        if self.peek() == "^":
            negate = True
            self.take()
        operands: List[np.ndarray] = []  # '&&'-separated, intersected
        mask = np.zeros(256, dtype=bool)
        first = True
        while True:
            c = self.peek()
            if c is None:
                self.error("unterminated character class")
            if c == "]" and not first:
                self.take()
                break
            first = False
            if c == "&" and self.p[self.i:self.i + 2] == "&&":
                self.i += 2
                operands.append(mask)
                mask = np.zeros(256, dtype=bool)
                continue
            if c == "[":
                self.take()
                mask |= self._char_class()
                continue
            if c == "\\":
                self.take()
                mask |= self._escape()
                continue
            self.take()
            lo_ch = c
            if (self.peek() == "-" and self.i + 1 < len(self.p) and
                    self.p[self.i + 1] != "]"):
                self.take()
                hi_ch = self.take()
                if hi_ch == "\\":
                    self.error("escape as range endpoint unsupported")
                lo_b, hi_b = ord(lo_ch), ord(hi_ch)
                if lo_b > 127 or hi_b > 127:
                    # code points are not bytes beyond ASCII (UTF-8)
                    raise RegexUnsupported(
                        "non-ASCII range in character class")
                if lo_b > hi_b:
                    self.error("bad class range")
                mask[lo_b:hi_b + 1] = True
            else:
                b = lo_ch.encode("utf-8")
                if len(b) > 1:
                    raise RegexUnsupported(
                        "non-ASCII in character class")
                mask[b[0]] = True
        for m in operands:
            mask &= m
        return ~mask if negate else mask


# ------------------------------------------------------------ NFA -> DFA

def estimate_states(node: _Node) -> int:
    """Pre-construction size estimate (the RegexComplexityEstimator
    role): bounded repeats multiply their body, so nested {m,n} blow up
    combinatorially — predict and tag CPU fallback BEFORE paying the
    NFA build + determinization."""
    if isinstance(node, _Chars):
        return 1
    if isinstance(node, _Concat):
        return sum(estimate_states(p) for p in node.parts) + 1
    if isinstance(node, _Alt):
        return sum(estimate_states(o) for o in node.options) + 2
    if isinstance(node, _Repeat):
        body = estimate_states(node.child)
        n = node.hi if node.hi is not None else node.lo + 1
        return body * max(n, 1) + 2
    raise AssertionError(node)


class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []      # state -> eps targets
        self.trans: List[List[Tuple[int, int]]] = []  # (mask_id, target)
        self.masks: List[np.ndarray] = []

    def new_state(self) -> int:
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1

    def add_mask(self, mask: np.ndarray) -> int:
        for i, m in enumerate(self.masks):
            if np.array_equal(m, mask):
                return i
        self.masks.append(mask)
        return len(self.masks) - 1


def _build(nfa: _NFA, node: _Node, start: int) -> int:
    """Wire `node` from `start`; return its end state."""
    if isinstance(node, _Chars):
        end = nfa.new_state()
        nfa.trans[start].append((nfa.add_mask(node.mask), end))
        return end
    if isinstance(node, _Concat):
        cur = start
        for part in node.parts:
            cur = _build(nfa, part, cur)
        return cur
    if isinstance(node, _Alt):
        end = nfa.new_state()
        for opt in node.options:
            s = nfa.new_state()
            nfa.eps[start].append(s)
            e = _build(nfa, opt, s)
            nfa.eps[e].append(end)
        return end
    if isinstance(node, _Repeat):
        cur = start
        for _ in range(node.lo):
            cur = _build(nfa, node.child, cur)
        if node.hi is None:
            # loop: child from cur back to cur
            s = nfa.new_state()
            nfa.eps[cur].append(s)
            e = _build(nfa, node.child, s)
            nfa.eps[e].append(s)
            end = nfa.new_state()
            nfa.eps[cur].append(end)
            nfa.eps[e].append(end)
            return end
        for _ in range(node.hi - node.lo):
            nxt = _build(nfa, node.child, cur)
            nfa.eps[cur].append(nxt)  # optional
            cur = nxt
        return cur
    raise AssertionError(node)


class CompiledRegex:
    """DFA tables ready for the device kernel.

    table:   [n_states, n_classes] int32 next-state
    classes: [256] int32 byte -> class
    accept:  [n_states] bool
    start:   int
    """

    def __init__(self, table, classes, accept, start, pattern):
        self.table = table
        self.classes = classes
        self.accept = accept
        self.start = start
        self.pattern = pattern

    @property
    def n_states(self):
        return self.table.shape[0]

    def match_host(self, data: bytes) -> bool:
        """Reference host implementation (tests / CPU path). Accept is
        only checked at end-of-input: unanchored-end patterns have
        absorbing accept states, so mid-string matches stick."""
        s = self.start
        for b in data:
            s = int(self.table[s, self.classes[b]])
        return bool(self.accept[s])


def compile_search(pattern: str,
                   loose_limits: bool = False) -> CompiledRegex:
    """Compile a pattern with Spark RLIKE (find-anywhere) semantics.
    Anchors bind PER top-level branch (Java: "^a|b" anchors only the
    first branch): start-anchored branches enter only at position 0,
    while unanchored ones also enter from the any-byte search loop;
    $-anchored branches accept only at end-of-input, others absorb."""
    parser = _Parser(pattern)
    branches = parser.parse_branches()
    limit = _conf_limit(_rc.REGEX_COMPLEXITY_LIMIT, loose_limits)
    est = sum(estimate_states(node) for node, _, _ in branches)
    if est > limit:
        raise RegexUnsupported(
            f"estimated NFA size {est} exceeds {limit} for "
            f"{pattern!r} (complexity gate)")
    max_states = _conf_limit(_rc.REGEX_MAX_STATES, loose_limits)
    nfa = _NFA()
    start = nfa.new_state()
    search = None
    if any(not a_s for _, a_s, _ in branches):
        search = nfa.new_state()
        nfa.trans[search].append((nfa.add_mask(_ANY.copy()), search))
        nfa.eps[start].append(search)
    absorbing_accept = set()  # unanchored-end: once found, stays found
    end_accept = set()        # $-anchored: accept only at end of input
    for node, a_s, a_e in branches:
        entry = nfa.new_state()
        nfa.eps[start if a_s else search].append(entry)
        final = _build(nfa, node, entry)
        if a_e:
            # `$` matches at end-of-input OR just before one final
            # '\n' — the Python-re semantics the engine's CPU oracle
            # uses. (Java Matcher additionally treats \r, \r\n and the
            # unicode line separators U+0085/U+2028/U+2029 as
            # terminators; those stay outside the transpiled subset,
            # the same caveat class as the byte-oriented `.`.)
            nl = np.zeros(256, dtype=bool)
            nl[0x0A] = True
            final_nl = nfa.new_state()
            nfa.trans[final].append((nfa.add_mask(nl), final_nl))
            end_accept |= {final, final_nl}
        else:
            absorbing_accept.add(final)
    accept_nfa = absorbing_accept | end_accept
    n = len(nfa.eps)

    # epsilon closures
    closures: List[frozenset] = []
    for s in range(n):
        seen = {s}
        stack = [s]
        while stack:
            x = stack.pop()
            for t in nfa.eps[x]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        closures.append(frozenset(seen))

    # byte -> class partition by signature across masks
    nmasks = len(nfa.masks)
    sig = np.zeros((256, nmasks), dtype=bool)
    for mi, m in enumerate(nfa.masks):
        sig[:, mi] = m
    _, classes = np.unique(sig, axis=0, return_inverse=True)
    n_classes = int(classes.max()) + 1
    # class -> representative byte
    rep = np.zeros(n_classes, dtype=np.int32)
    for cl in range(n_classes):
        rep[cl] = int(np.argmax(classes == cl))

    # subset construction
    start_set = closures[start]
    dfa_states = {start_set: 0}
    order = [start_set]
    table_rows: List[List[int]] = []
    accept_flags: List[bool] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        is_abs = any(s in absorbing_accept for s in cur)
        is_acc = is_abs or any(s in end_accept for s in cur)
        accept_flags.append(is_acc)
        row = []
        for cl in range(n_classes):
            b = rep[cl]
            nxt = set()
            if is_abs:
                # absorbing accept: once found, stay accepted
                row.append(-1)  # patched below
                continue
            for s in cur:
                for mid, tgt in nfa.trans[s]:
                    if nfa.masks[mid][b]:
                        nxt |= closures[tgt]
            key = frozenset(nxt)
            if key not in dfa_states:
                if len(dfa_states) >= max_states:
                    raise RegexUnsupported(
                        f"DFA exceeds {max_states} states for "
                        f"{pattern!r}")
                dfa_states[key] = len(order)
                order.append(key)
            row.append(dfa_states[key])
        table_rows.append(row)

    table = np.array(table_rows, dtype=np.int32)
    accept = np.array(accept_flags, dtype=bool)
    # patch absorbing accepts: self-loop
    for si in range(table.shape[0]):
        for cl in range(table.shape[1]):
            if table[si, cl] == -1:
                table[si, cl] = si
    return CompiledRegex(table, classes.astype(np.int32), accept, 0,
                         pattern)
