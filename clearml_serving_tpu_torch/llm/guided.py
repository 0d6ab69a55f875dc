"""Grammar-constrained (guided) decoding: the grammar compiler.

The port's copy of ``clearml_serving_tpu/llm/guided.py``, numpy only, so the
port imports nothing of the JAX package. Its tables must stay bit for bit the
reference's (``tests/test_torch_guided.py`` holds them against each other).

Design: compile the constraint once on the host into a byte-level DFA over
the combined grammar registry, plus a packed per-state token mask
``mask_bits[state] -> allowed token ids``. The decode chunk keeps one DFA
state per slot on the device; each step masks the logits with the state's
bit row, samples, and walks the sampled token's bytes through the byte
table (``llm/sampling.py`` ``guided_mask`` / ``guided_advance``). No host
round trip, no per-step rebuild. EOS is allowed only in accepting states,
so generation can only stop on a complete match.

Pipeline: regex subset --Thompson--> byte NFA --subset construction over
byte equivalence classes--> byte DFA --per-token byte walk (vectorized
numpy)--> token mask. JSON schemas lower to regexes (Outlines-style);
``json_object`` mode uses a bounded-nesting JSON value regex.

Supported regex subset: literals (UTF-8), ``.`` ``|`` ``( )`` ``* + ?``
``{m}`` ``{m,n}``, classes ``[a-z^...]``, escapes ``\\d \\w \\s \\D \\W
\\S \\n \\r \\t \\f \\v`` and escaped metacharacters. Anchoring is
implicit (whole-string match); a leading ``^`` / trailing ``$`` are no-ops.
Anything outside the subset (``\\b`` ``\\B`` ``\\A`` ``\\Z``,
backreferences, mid-pattern anchors, lookaround) raises RegexError, so an
unsupported pattern fails the 4xx pre-flight instead of compiling into a
grammar that forces literal characters.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEAD = -1  # dead/forbidden marker in transition tables


# --------------------------------------------------------------- regex AST

class _Node:
    pass


@dataclass
class _Lit(_Node):
    bytes_: frozenset  # allowed byte values for this single position


@dataclass
class _Concat(_Node):
    parts: List[_Node]


@dataclass
class _Alt(_Node):
    options: List[_Node]


@dataclass
class _Repeat(_Node):
    node: _Node
    min: int
    max: Optional[int]  # None = unbounded


_ANY = frozenset(range(256)) - {0x0A}  # '.' = any byte except newline
_DIGIT = frozenset(range(0x30, 0x3A))
_WORD = (
    frozenset(range(0x30, 0x3A))
    | frozenset(range(0x41, 0x5B))
    | frozenset(range(0x61, 0x7B))
    | {0x5F}
)
_SPACE = frozenset(b" \t\n\r\f\v")
_ALL = frozenset(range(256))


class RegexError(ValueError):
    pass


# named escape -> byte set, shared by _escape (pattern level) and
# _class_atom (inside [...]) so the two can never drift apart
_ESCAPE_SETS = {"d": _DIGIT, "w": _WORD, "s": _SPACE,
                "D": _ALL - _DIGIT, "W": _ALL - _WORD, "S": _ALL - _SPACE,
                "n": frozenset(b"\n"), "r": frozenset(b"\r"),
                "t": frozenset(b"\t"), "f": frozenset(b"\f"),
                "v": frozenset(b"\v")}


class _Parser:
    """Recursive-descent parser over the regex subset, operating on the
    pattern's UTF-8 bytes (multi-byte literals become byte concats)."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.n = len(pattern)

    def parse(self) -> _Node:
        node = self._alt()
        if self.i != self.n:
            raise RegexError(
                "unexpected {!r} at {}".format(self.p[self.i], self.i)
            )
        return node

    def _alt(self) -> _Node:
        options = [self._concat()]
        while self.i < self.n and self.p[self.i] == "|":
            self.i += 1
            options.append(self._concat())
        return options[0] if len(options) == 1 else _Alt(options)

    def _concat(self) -> _Node:
        parts: List[_Node] = []
        while self.i < self.n and self.p[self.i] not in "|)":
            parts.append(self._repeat())
        return _Concat(parts)

    def _repeat(self) -> _Node:
        node = self._atom()
        while self.i < self.n and self.p[self.i] in "*+?{":
            ch = self.p[self.i]
            if ch == "*":
                node, self.i = _Repeat(node, 0, None), self.i + 1
            elif ch == "+":
                node, self.i = _Repeat(node, 1, None), self.i + 1
            elif ch == "?":
                node, self.i = _Repeat(node, 0, 1), self.i + 1
            else:  # {m} / {m,} / {m,n}
                j = self.p.find("}", self.i)
                if j < 0:
                    raise RegexError("unterminated {} quantifier")
                body = self.p[self.i + 1 : j]
                if "," in body:
                    lo, hi = body.split(",", 1)
                    node = _Repeat(
                        node, int(lo or 0), int(hi) if hi.strip() else None
                    )
                else:
                    node = _Repeat(node, int(body), int(body))
                self.i = j + 1
        return node

    def _atom(self) -> _Node:
        ch = self.p[self.i]
        if ch == "(":
            self.i += 1
            if self.p.startswith("?:", self.i):  # non-capturing marker
                self.i += 2
            node = self._alt()
            if self.i >= self.n or self.p[self.i] != ")":
                raise RegexError("unbalanced parenthesis")
            self.i += 1
            return node
        if ch == "[":
            return self._char_class()
        if ch == ".":
            self.i += 1
            return _Lit(_ANY)
        if ch == "\\":
            return self._escape()
        if ch in "*+?{":
            raise RegexError("dangling quantifier at {}".format(self.i))
        if ch == "^":
            if self.i == 0:  # leading anchor: no-op, matching is anchored
                self.i += 1
                return _Concat([])
            raise RegexError(
                "'^' mid-pattern unsupported (matching is whole-string)"
            )
        if ch == "$":
            if self.i == self.n - 1:  # trailing anchor: no-op
                self.i += 1
                return _Concat([])
            raise RegexError(
                "'$' mid-pattern unsupported (matching is whole-string)"
            )
        self.i += 1
        data = ch.encode("utf-8")
        if len(data) == 1:
            return _Lit(frozenset(data))
        return _Concat([_Lit(frozenset([b])) for b in data])

    def _escape(self) -> _Node:
        self.i += 1
        if self.i >= self.n:
            raise RegexError("trailing backslash")
        ch = self.p[self.i]
        self.i += 1
        if ch in _ESCAPE_SETS:
            return _Lit(_ESCAPE_SETS[ch])
        if ch == "x":  # \xNN byte escape
            hexpair = self.p[self.i : self.i + 2]
            if len(hexpair) != 2:
                raise RegexError("truncated \\x escape")
            self.i += 2
            return _Lit(frozenset([int(hexpair, 16)]))
        if ch.isalnum():  # \b \B \A \Z, backrefs, \p{..}: NOT literals
            raise RegexError(
                "unsupported escape \\{} (outside the guided-regex "
                "subset)".format(ch)
            )
        return _Lit(frozenset(ch.encode("utf-8")[:1]))

    def _class_atom(self):
        """One class member: a byte value, or a named set (returns a set)."""
        if self.p[self.i] == "\\":
            self.i += 1
            ch = self.p[self.i]
            self.i += 1
            if ch in _ESCAPE_SETS:
                return _ESCAPE_SETS[ch]
            if ch == "x":
                hexpair = self.p[self.i : self.i + 2]
                if len(hexpair) != 2:
                    raise RegexError("truncated \\x escape in class")
                self.i += 2
                return int(hexpair, 16)
            if ch.isalnum():
                raise RegexError(
                    "unsupported escape \\{} in character class".format(ch)
                )
            return ch.encode("utf-8")[0]
        enc = self.p[self.i].encode("utf-8")
        if len(enc) != 1:
            raise RegexError("non-ASCII in char class unsupported")
        self.i += 1
        return enc[0]

    def _char_class(self) -> _Node:
        self.i += 1  # past '['
        negate = self.i < self.n and self.p[self.i] == "^"
        if negate:
            self.i += 1
        members: set = set()
        first = True
        while self.i < self.n and (self.p[self.i] != "]" or first):
            first = False
            atom = self._class_atom()
            if isinstance(atom, frozenset):
                members |= atom
                continue
            if (
                self.i + 1 < self.n
                and self.p[self.i] == "-"
                and self.p[self.i + 1] != "]"
            ):
                self.i += 1
                hi = self._class_atom()
                if isinstance(hi, frozenset):
                    raise RegexError("named set cannot end a range")
                members |= set(range(atom, hi + 1))
            else:
                members.add(atom)
        if self.i >= self.n:
            raise RegexError("unterminated character class")
        self.i += 1  # past ']'
        if negate:
            members = set(range(256)) - members
        return _Lit(frozenset(members))


# ------------------------------------------------------------ NFA -> DFA

class _NFA:
    """Thompson NFA: states are ints; eps[s] = set of states;
    edges[s] = list of (byteset, target)."""

    def __init__(self):
        self.eps: List[set] = []
        self.edges: List[List[Tuple[frozenset, int]]] = []

    def new_state(self) -> int:
        self.eps.append(set())
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, node: _Node) -> Tuple[int, int]:
        """Returns (start, accept) fragment for `node`."""
        if isinstance(node, _Lit):
            s, a = self.new_state(), self.new_state()
            self.edges[s].append((node.bytes_, a))
            return s, a
        if isinstance(node, _Concat):
            s = a = self.new_state()
            for part in node.parts:
                ps, pa = self.build(part)
                self.eps[a].add(ps)
                a = pa
            return s, a
        if isinstance(node, _Alt):
            s, a = self.new_state(), self.new_state()
            for opt in node.options:
                os_, oa = self.build(opt)
                self.eps[s].add(os_)
                self.eps[oa].add(a)
            return s, a
        if isinstance(node, _Repeat):
            lo, hi = node.min, node.max
            s = a = self.new_state()
            for _ in range(lo):  # mandatory copies
                ps, pa = self.build(node.node)
                self.eps[a].add(ps)
                a = pa
            if hi is None:  # Kleene tail
                ps, pa = self.build(node.node)
                self.eps[a].add(ps)
                self.eps[pa].add(a)
            else:
                end = self.new_state()
                self.eps[a].add(end)
                for _ in range(hi - lo):  # optional copies
                    ps, pa = self.build(node.node)
                    self.eps[a].add(ps)
                    self.eps[pa].add(end)
                    a = pa
                a = end
            return s, a


def _eps_closure(nfa: _NFA, states: frozenset) -> frozenset:
    stack, seen = list(states), set(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


@dataclass
class ByteDFA:
    """Dense byte-level DFA: trans [S, 256] int32 (DEAD = -1), accepting
    [S] bool, start = 0."""

    trans: np.ndarray
    accepting: np.ndarray

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    @classmethod
    def from_regex(
        cls,
        pattern: str,
        max_states: int = 4096,
        allow_leading_space: bool = False,
    ) -> "ByteDFA":
        """``allow_leading_space`` prepends an optional ' ' at the AST
        level (SPM detokenization strips it) — string-level wrapping would
        push a user's no-op leading '^' / trailing '$' into mid-pattern
        position and fail patterns the pre-flight already accepted."""
        ast = _Parser(pattern).parse()
        if allow_leading_space:
            ast = _Concat([_Repeat(_Lit(frozenset([0x20])), 0, 1), ast])
        nfa = _NFA()
        start, accept = nfa.build(ast)

        # byte equivalence classes: partition bytes by NFA-edge signature so
        # the subset construction touches ~tens of classes, not 256 bytes
        sig = {}
        for b in range(256):
            key = []
            for s, edges in enumerate(nfa.edges):
                for ei, (bs, _t) in enumerate(edges):
                    if b in bs:
                        key.append((s, ei))
            sig.setdefault(tuple(key), []).append(b)
        classes = list(sig.values())

        d0 = _eps_closure(nfa, frozenset([start]))
        index: Dict[frozenset, int] = {d0: 0}
        rows: List[np.ndarray] = [np.full(256, DEAD, np.int32)]
        work = [d0]
        while work:
            cur = work.pop()
            ci = index[cur]
            for cls_bytes in classes:
                rep = cls_bytes[0]
                nxt = set()
                for s in cur:
                    for bs, t in nfa.edges[s]:
                        if rep in bs:
                            nxt.add(t)
                if not nxt:
                    continue
                closed = _eps_closure(nfa, frozenset(nxt))
                if closed not in index:
                    if len(index) >= max_states:
                        raise RegexError(
                            "DFA exceeds {} states; simplify the "
                            "pattern/schema".format(max_states)
                        )
                    index[closed] = len(rows)
                    rows.append(np.full(256, DEAD, np.int32))
                    work.append(closed)
                ti = index[closed]
                row = rows[ci]
                for b in cls_bytes:
                    row[b] = ti
        trans = np.stack(rows)
        accepting = np.zeros(len(rows), bool)
        for states, i in index.items():
            if accept in states:
                accepting[i] = True
        return cls(trans=trans, accepting=accepting)

    def matches(self, data: bytes) -> bool:
        s = 0
        for b in data:
            s = int(self.trans[s, b])
            if s == DEAD:
                return False
        return bool(self.accepting[s])


# ------------------------------------------------------- token-level table

@dataclass
class TokenDFA:
    """Token-level transition table over a model vocabulary.

    table [S+1, V] int16: table[s, t] = state after emitting token t from s
    (DEAD if t's byte path dies, or if it ends the match without reaching
    an accepting byte-state mid-token — partial progress through a token is
    fine, the BYTES must stay alive). Row S (the last row) is the terminal
    post-EOS self-loop state. EOS column: accepting states -> terminal,
    others DEAD. Terminal row: everything DEAD except EOS (self-loop).
    """

    table: np.ndarray
    start: int = 0

    @property
    def n_states(self) -> int:
        return self.table.shape[0]

    @classmethod
    def build(
        cls,
        dfa: ByteDFA,
        token_bytes: Sequence[Optional[bytes]],
        eos_id: int,
    ) -> "TokenDFA":
        S = dfa.n_states
        V = len(token_bytes)
        if S + 1 > np.iinfo(np.int16).max:
            raise RegexError("token DFA too large for int16 states")
        # vectorized byte walk: state_mat [S, V] starts at each DFA state,
        # consumes every token's bytes in lockstep (grouped by position)
        max_len = max((len(t) for t in token_bytes if t), default=0)
        lens = np.array(
            [len(t) if t else 0 for t in token_bytes], np.int32
        )
        state_mat = np.repeat(
            np.arange(S, dtype=np.int32)[:, None], V, axis=1
        )  # [S, V]
        trans_pad = np.vstack([dfa.trans, np.full((1, 256), DEAD, np.int32)])
        for pos in range(max_len):
            live_tok = lens > pos
            if not live_tok.any():
                break
            byte_at = np.zeros(V, np.int64)
            for t in np.nonzero(live_tok)[0]:
                byte_at[t] = token_bytes[t][pos]
            cur = state_mat[:, live_tok]
            nxt = trans_pad[np.where(cur == DEAD, S, cur), byte_at[live_tok]]
            state_mat[:, live_tok] = nxt
        # zero-length / special tokens are never allowed
        state_mat[:, lens == 0] = DEAD
        table = np.vstack([state_mat, np.full((1, V), DEAD, np.int32)])
        terminal = S
        if 0 <= eos_id < V:
            table[:S, eos_id] = np.where(dfa.accepting, terminal, DEAD)
            table[terminal, eos_id] = terminal
        # Fixpoint-prune token-level dead ends: a byte-state can be alive at
        # byte granularity yet unreachable-forward at TOKEN granularity (no
        # whole vocab token survives from it). Without pruning the engine
        # could sample into such a state and find every next token masked.
        for _ in range(S + 1):
            alive = (table != DEAD).any(axis=1)
            into_dead = (table != DEAD) & ~alive[np.clip(table, 0, None)]
            if not into_dead.any():
                break
            table[into_dead] = DEAD
        if not (table[0] != DEAD).any():
            raise RegexError(
                "no vocabulary token can begin a match of this grammar"
            )
        return cls(table=table.astype(np.int16))


_BYTE_DECODER: Optional[Dict[str, int]] = None


def _gpt2_byte_decoder() -> Dict[str, int]:
    """Inverse of the byte-level-BPE bytes->unicode table (GPT-2 alphabet,
    used by Llama-3/Qwen/GPT-style HF fast tokenizers): printable bytes map
    to themselves, the rest to U+0100+n. Public, well-known construction."""
    global _BYTE_DECODER
    if _BYTE_DECODER is None:
        bs = (
            list(range(0x21, 0x7F))
            + list(range(0xA1, 0xAD))
            + list(range(0xAE, 0x100))
        )
        cs = bs[:]
        n = 0
        for b in range(256):
            if b not in bs:
                bs.append(b)
                cs.append(0x100 + n)
                n += 1
        _BYTE_DECODER = {chr(c): b for b, c in zip(bs, cs)}
    return _BYTE_DECODER


def token_byte_table(tokenizer, vocab_size: int) -> List[Optional[bytes]]:
    """Bytes each vocab id contributes to the output text (None for
    specials/unused ids — those are never allowed by a guided mask).

    Per-id ``decode([i])`` is NOT used: HF decode strips SentencePiece word
    markers (so '▁world' would lose its space) and renders partial-UTF-8
    byte-level pieces as U+FFFD. Instead the raw vocab pieces are mapped:
    SentencePiece '▁'->space and '<0xNN>' byte pieces; byte-level BPE via
    the inverse GPT-2 byte-unicode alphabet. The two conventions are
    disambiguated by probing the vocab for '▁' pieces."""
    specials = {
        getattr(tokenizer, name, None)
        for name in ("bos_token_id", "eos_token_id", "pad_token_id")
    }
    hf = getattr(tokenizer, "_tok", None)
    out: List[Optional[bytes]] = []
    if hf is None:  # ByteTokenizer: ids 0..255 ARE bytes
        for i in range(vocab_size):
            if i in specials or i >= 256:
                out.append(None)
            else:
                out.append(bytes([i]))
        return out

    specials |= set(getattr(hf, "all_special_ids", None) or [])
    pieces = hf.convert_ids_to_tokens(list(range(vocab_size)))
    spm = any(p is not None and "▁" in p for p in pieces)
    try:  # share the probe with _is_spm_tokenizer: one O(V) walk, one truth
        tokenizer._spm_convention = spm
    except Exception:
        pass
    bd = _gpt2_byte_decoder()
    for i, p in enumerate(pieces):
        if i in specials or p is None:
            out.append(None)
            continue
        try:
            if spm:
                if p.startswith("<0x") and p.endswith(">") and len(p) == 6:
                    out.append(bytes([int(p[3:5], 16)]))  # sp byte fallback
                else:
                    out.append(p.replace("▁", " ").encode("utf-8"))
            elif all(ch in bd for ch in p):
                out.append(bytes(bd[ch] for ch in p))  # byte-level BPE
            else:
                out.append(p.encode("utf-8"))
        except Exception:
            out.append(None)
    return out


# ------------------------------------------------------- JSON -> regex

# control bytes excluded and \u forced to 4 hex digits: strict JSON parsers
# (json.loads) reject raw 0x00-0x1f inside strings and partial \u escapes
_JSON_STRING = r'"([^"\\\x00-\x1f]|\\(["\\/bfnrt]|u[0-9a-fA-F]{4}))*"'
_JSON_INT = r"-?(0|[1-9][0-9]*)"
_JSON_NUM = r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][-+]?[0-9]+)?"
_WS = r"[ ]?"


def _regex_escape_literal(text: str) -> str:
    out = []
    for ch in text:
        if ch in r"\.[]{}()*+?|^$/":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def json_schema_to_regex(schema: dict, depth: int = 4) -> str:
    """Lower a JSON-schema subset to a whole-string regex (Outlines-style).

    Supported: type object (properties + required, in declaration order),
    string (incl. enum/const), integer, number, boolean, null, array
    (items, minItems/maxItems, default 0..8), anyOf, $-less nesting.
    """
    if depth < 0:
        raise RegexError("schema nesting too deep for guided decoding")
    if not isinstance(schema, dict):
        raise RegexError("schema must be an object")
    if "enum" in schema:
        return "({})".format(
            "|".join(
                _regex_escape_literal(json.dumps(v)) for v in schema["enum"]
            )
        )
    if "const" in schema:
        return _regex_escape_literal(json.dumps(schema["const"]))
    if "anyOf" in schema:
        return "({})".format(
            "|".join(json_schema_to_regex(s, depth - 1) for s in schema["anyOf"])
        )
    t = schema.get("type")
    if t == "string":
        return _JSON_STRING
    if t == "integer":
        return _JSON_INT
    if t == "number":
        return _JSON_NUM
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = json_schema_to_regex(schema.get("items", {}), depth - 1)
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", 8))
        if lo == 0:
            body = "({i}(,{w}{i}){{0,{n}}})?".format(i=item, w=_WS, n=max(hi - 1, 0))
        else:
            body = "{i}(,{w}{i}){{{m},{n}}}".format(
                i=item, w=_WS, m=lo - 1, n=max(hi - 1, lo - 1)
            )
        return r"\[" + _WS + body + _WS + r"\]"
    if (
        t == "object"
        and not schema.get("properties")
        and not schema.get("required")
        and schema.get("additionalProperties") is not False
    ):
        # no declared properties = ANY object (JSON Schema), not the empty
        # object: lower to a bounded any-object like json_object mode.
        # With an explicit `additionalProperties: false` the schema instead
        # falls through to the declared-properties branch, whose empty
        # member list lowers to exactly `{}` — the closed-object semantics
        # OpenAI strict tool calling pins (llm/tools.tool_call_schema).
        # (additionalProperties is otherwise not modeled — documented
        # subset limitation; a declared-properties object is already
        # closed over its declared members by construction.)
        _arr, obj = _json_container_regexes(json_value_regex(min(depth, 2)))
        return obj
    if t == "object" or "properties" in schema:
        props = schema.get("properties") or {}
        if not props and schema.get("required"):
            # required-only object: presence of the required members IS the
            # constraint — enforce them (any JSON value), declaration order
            props = {str(r): {} for r in schema["required"]}
        # JSON Schema semantics (and Outlines): absent `required` means NO
        # property is required, not all of them
        required = set(schema.get("required") or [])
        pieces = [
            (
                '"{}":{}{}'.format(
                    _regex_escape_literal(name), _WS,
                    json_schema_to_regex(sub, depth - 1),
                ),
                name in required,
            )
            for name, sub in props.items()
        ]
        comma = "," + _WS
        req_idx = [i for i, (_p, r) in enumerate(pieces) if r]
        if req_idx:
            # anchor commas on the first REQUIRED property: optionals before
            # it carry a trailing comma, everything after a leading one —
            # separators stay correct for any subset of optionals
            first = req_idx[0]
            out = []
            for i, (p, r) in enumerate(pieces):
                if i < first:
                    out.append("({}{})?".format(p, comma))
                elif i == first:
                    out.append(p)
                elif r:
                    out.append(comma + p)
                else:
                    out.append("({}{})?".format(comma, p))
            body = "".join(out)
        elif pieces:
            # all optional: alternation over the FIRST present property;
            # every later property then optionally follows with a leading
            # comma. Quadratic pattern size (sum of suffix lengths) — the
            # previous suffix-recursion duplicated the tail twice per
            # property, i.e. exponential, and a ~28-optional-property
            # schema could OOM the pre-flight
            alts = []
            for i, (p, _r) in enumerate(pieces):
                rest = "".join(
                    "({}{})?".format(comma, q) for q, _r2 in pieces[i + 1 :]
                )
                alts.append(p + rest)
            body = "({})?".format("|".join(alts))
        else:
            body = ""
        return r"\{" + _WS + body + _WS + r"\}"
    # untyped: any bounded JSON value
    return json_value_regex(min(depth, 2))


def _json_container_regexes(value: str) -> Tuple[str, str]:
    # Kleene stars, not bounded repeats: {0,N} COPIES the whole nested
    # fragment N times in the NFA (exponential across depths); a star is
    # a loop edge and keeps the automaton linear in the regex size
    arr = r"\[" + _WS + "({v}(,{w}{v})*)?".format(v=value, w=_WS) + _WS + r"\]"
    obj = (
        r"\{" + _WS
        + "({k}:{w}{v}(,{w}{k}:{w}{v})*)?".format(
            k=_JSON_STRING, w=_WS, v=value
        )
        + _WS + r"\}"
    )
    return arr, obj


def json_value_regex(depth: int = 3) -> str:
    """Any JSON value with nesting bounded to `depth` (regular languages
    can't count braces; bounded depth is the standard trade)."""
    scalar = "({}|{}|true|false|null)".format(_JSON_STRING, _JSON_NUM)
    value = scalar
    for _ in range(depth):
        arr, obj = _json_container_regexes(value)
        value = "({}|{}|{})".format(scalar, arr, obj)
    return value


def json_object_regex(depth: int = 3) -> str:
    """A JSON OBJECT at top level (OpenAI json_object semantics: "the model
    must output a JSON object", not any JSON value), members nested to
    `depth`."""
    _arr, obj = _json_container_regexes(json_value_regex(max(depth - 1, 0)))
    return obj


# ------------------------------------------------------------ public entry

@dataclass(frozen=True)
class GuidedSpec:
    """What the API layer hands the engine. kind: 'regex' | 'json_schema' |
    'json_object'; payload: pattern string / schema-JSON string / ''."""

    kind: str
    payload: str = ""

    def cache_key(self) -> str:
        return "{}:{}".format(self.kind, self.payload)


@dataclass
class CompiledGrammar:
    """Device-friendly compiled form. A dense [S, V] token table costs
    S*V*2 bytes (770 MB for json_object over a 128k vocab) — instead:

    - mask_bits [S+1, ceil(V/8)] uint8: bitpacked allowed-token sets
      (little bit order: token v -> byte v//8, bit v%8). 16x smaller; the
      decode chunk gathers a state's row and bit-expands on device. Row S is
      the post-EOS terminal (only the EOS bit set).
    - byte_trans [S+1, 256] int16: the BYTE DFA (+ all-DEAD terminal row).
      State advance re-walks the sampled token's bytes on device — a
      [B, Lmax] fixed loop of tiny gathers instead of a V-wide row.

    Token-level pruning already happened on the full table, so any token
    admitted by mask_bits byte-walks to a token-live state; mask and walk
    agree by construction.
    """

    mask_bits: np.ndarray
    byte_trans: np.ndarray
    start: int
    terminal: int

    @property
    def n_states(self) -> int:
        return self.mask_bits.shape[0]


def pack_token_mask(table: np.ndarray) -> np.ndarray:
    """[S, V] transition table -> [S, ceil(V/8)] little-order bitmask."""
    return np.packbits(table != DEAD, axis=1, bitorder="little")


def build_token_byte_arrays(
    token_bytes: Sequence[Optional[bytes]], max_len: int = 16
) -> Tuple[np.ndarray, np.ndarray]:
    """(tok_bytes [V, max_len] uint8, tok_len [V] int32) for the on-device
    byte walk. Tokens longer than max_len get len 0 — compile_guided
    forbids them in every grammar so the walk never sees one."""
    V = len(token_bytes)
    tb = np.zeros((V, max_len), np.uint8)
    tl = np.zeros((V,), np.int32)
    for i, t in enumerate(token_bytes):
        if t and len(t) <= max_len:
            tb[i, : len(t)] = np.frombuffer(t, np.uint8)
            tl[i] = len(t)
    return tb, tl


def _is_spm_tokenizer(tokenizer, vocab_size: int) -> bool:
    """True for SentencePiece-convention tokenizers (pieces use '▁' word
    markers and decode strips the sequence-leading space). Byte-level BPE
    (GPT-2/Llama-3 alphabet) returns False: there decode PRESERVES the
    leading space, so the grammar must not admit one.

    Uses the SAME vocab probe as token_byte_table (any '▁' piece) so the
    grammar's leading-space branch and the byte table can never disagree;
    the O(V) walk is cached on the tokenizer wrapper."""
    hf = getattr(tokenizer, "_tok", None)
    if hf is None:
        return False
    flag = getattr(tokenizer, "_spm_convention", None)
    if flag is None:
        try:
            pieces = hf.convert_ids_to_tokens(list(range(vocab_size)))
            flag = any(p is not None and "▁" in p for p in pieces)
        except Exception:
            flag = False
        try:
            tokenizer._spm_convention = flag
        except Exception:
            pass
    return flag


def compile_guided(
    spec: GuidedSpec, tokenizer, vocab_size: int, eos_id: int,
    max_states: int = 8192, max_token_bytes: int = 16,
    token_bytes: Optional[Sequence[Optional[bytes]]] = None,
) -> CompiledGrammar:
    """``token_bytes``: pass a cached token_byte_table() to skip the O(V)
    vocab walk per grammar (the engine caches one per tokenizer)."""
    if spec.kind == "regex":
        pattern = spec.payload
    elif spec.kind == "json_schema":
        pattern = json_schema_to_regex(json.loads(spec.payload))
    elif spec.kind == "json_object":
        pattern = json_object_regex(3)
    else:
        raise RegexError("unknown guided kind {!r}".format(spec.kind))
    # SentencePiece detokenization strips one leading space ('▁word' at
    # sequence start decodes to "word"), so the natural word-start pieces
    # contribute " word" bytes and a grammar anchored at string start
    # would steer the model away from its highest-probability tokenization.
    # Allow exactly one optional leading space: it vanishes
    # in decode, so emitted text still matches the original pattern.
    dfa = ByteDFA.from_regex(
        pattern,
        max_states=max_states,
        allow_leading_space=_is_spm_tokenizer(tokenizer, vocab_size),
    )
    if token_bytes is None:
        token_bytes = token_byte_table(tokenizer, vocab_size)
    tokens = list(token_bytes)
    for i, t in enumerate(tokens):  # over-long tokens can't be walked
        if t is not None and len(t) > max_token_bytes:
            tokens[i] = None
    tdfa = TokenDFA.build(dfa, tokens, eos_id)
    byte_trans = np.vstack(
        [dfa.trans, np.full((1, 256), DEAD, np.int32)]
    ).astype(np.int16)
    return CompiledGrammar(
        mask_bits=pack_token_mask(tdfa.table),
        byte_trans=byte_trans,
        start=0,
        terminal=dfa.n_states,
    )
