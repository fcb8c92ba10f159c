"""Constrained JSON decoding for tool calls.

Counterpart of kafka_tpu/llm/constrained.py, copied whole: it is numpy
only.  Two changes: the environment knobs take the KAFKA_TORCH_ spelling
(KAFKA_TORCH_GRAMMAR_ONDEVICE, _GRAMMAR_TABLE_MB, _GRAMMAR_SYNC_VOCAB), and
the deferred compile worker asks the port's autoscaler
(runtime/autoscaler.py) whether to hold its queue.


The engine's sampler accepts a per-request ``logits_mask_fn`` (runtime/
engine.py); this module supplies the brain behind it: a mask that forces
generations to be exactly

    {"name": "<declared tool>", "parameters": {<schema keys>: <JSON>}}

followed by end-of-turn — so forced tool calls always parse, the name is
always a declared tool, and top-level parameter keys always come from the
tool's JSON-schema ``properties`` (free JSON is allowed inside values,
and for tools that declare no properties).

Design, sized for a 128k vocab:

* a character-level **JSON pushdown automaton** (`JsonPDA`) validates free
  value regions incrementally — strings/escapes/\\u, the full number DFA,
  literals, nested containers;
* a **template automaton** (`ToolCallAutomaton`) walks the fixed skeleton,
  a trie of tool names, a per-tool trie of parameter keys, and delegates
  value regions to the PDA.  Canonical separators (`": "`, `", "`) keep the
  skeleton deterministic;
* a per-tokenizer **TokenIndex** (built once, cached) decodes every vocab
  token and buckets ids by first character, and precomputes the
  `string_safe` id set (no quote/backslash/control bytes).  Inside free
  string content the allowed set is that precomputed array plus a handful
  of trial-checked quote/escape tokens — never a Python scan of the vocab.
  Structural positions probe the automaton for legal next characters and
  trial-feed only the matching first-char buckets.

The reference could not do any of this: its sampler lived behind a remote
HTTPS gateway (src/llm/portkey.py), so tool-call JSON was best-effort.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

WS = " \t\n\r"
DIGITS = "0123456789"
# characters probed when asking an automaton "what may come next"
PROBE_CHARS = (
    "".join(chr(c) for c in range(0x20, 0x7F)) + "\t\n\r"
)


# ---------------------------------------------------------------------------
# character-level JSON automaton
# ---------------------------------------------------------------------------


class JsonPDA:
    """Incremental validator for a single JSON value.

    `feed(ch)` returns False (and leaves state undefined) on an illegal
    character; callers trial-feed copies.  `complete` is True when exactly
    one whole value has been consumed (numbers complete implicitly, so a
    terminal-number state with an empty stack also counts via
    `would_complete`)."""

    __slots__ = ("stack", "state", "lit", "max_depth")

    # number DFA states that may legally end the number
    _NUM_TERMINAL = {"num_zero", "num_int", "num_frac", "num_exp"}

    def __init__(self, max_depth: int = 8) -> None:
        self.stack: List[str] = []
        self.state = "value"
        self.lit = ""  # remaining chars of true/false/null
        # nesting cap: keeps the worst-case "distance to a valid close"
        # bounded, which the wrap-up mode (ToolCallMaskFn) relies on
        self.max_depth = max_depth

    def copy(self) -> "JsonPDA":
        c = JsonPDA.__new__(JsonPDA)
        c.stack = list(self.stack)
        c.state = self.state
        c.lit = self.lit
        c.max_depth = self.max_depth
        return c

    # -- helpers --------------------------------------------------------

    @property
    def complete(self) -> bool:
        return not self.stack and self.state == "end"

    @property
    def would_complete(self) -> bool:
        """True if ending input here yields a complete value (covers the
        implicit termination of top-level numbers)."""
        return self.complete or (
            not self.stack and self.state in self._NUM_TERMINAL
        )

    @property
    def in_string(self) -> bool:
        """Inside free string content (escape states excluded)."""
        return self.state in ("in_str", "key_str")

    def _value_done(self) -> None:
        self.state = "end"

    # -- transitions ----------------------------------------------------

    def feed(self, ch: str) -> bool:  # noqa: C901 (a DFA is a big switch)
        s = self.state
        # number states terminate implicitly: close, then re-dispatch
        if s.startswith("num"):
            if self._feed_num(ch):
                return True
            if s in self._NUM_TERMINAL:
                self._value_done()
                return self.feed(ch)
            return False

        if s == "value":
            if ch in WS:
                return True
            if ch == '"':
                self.state = "in_str"
            elif ch == "{":
                if len(self.stack) >= self.max_depth:
                    return False
                self.stack.append("obj")
                self.state = "key_or_close"
            elif ch == "[":
                if len(self.stack) >= self.max_depth:
                    return False
                self.stack.append("arr")
                self.state = "value_or_close"
            elif ch == "-":
                self.state = "num_minus"
            elif ch == "0":
                self.state = "num_zero"
            elif ch in "123456789":
                self.state = "num_int"
            elif ch == "t":
                self.state, self.lit = "lit", "rue"
            elif ch == "f":
                self.state, self.lit = "lit", "alse"
            elif ch == "n":
                self.state, self.lit = "lit", "ull"
            else:
                return False
            return True

        if s == "lit":
            if self.lit and ch == self.lit[0]:
                self.lit = self.lit[1:]
                if not self.lit:
                    self._value_done()
                return True
            return False

        if s == "in_str":
            if ch == '"':
                self._value_done()
            elif ch == "\\":
                self.state = "str_esc"
            elif ord(ch) < 0x20:
                return False
            return True
        if s == "str_esc":
            if ch in '"\\/bfnrt':
                self.state = "in_str"
            elif ch == "u":
                self.state = "str_u0"
            else:
                return False
            return True
        if s in ("str_u0", "str_u1", "str_u2", "str_u3"):
            if ch in "0123456789abcdefABCDEF":
                self.state = (
                    "in_str" if s == "str_u3" else f"str_u{int(s[-1]) + 1}"
                )
                return True
            return False

        # object machinery
        if s == "key_or_close":
            if ch in WS:
                return True
            if ch == '"':
                self.state = "key_str"
                return True
            if ch == "}":
                self.stack.pop()
                self._value_done()
                return True
            return False
        if s == "key":
            if ch in WS:
                return True
            if ch == '"':
                self.state = "key_str"
                return True
            return False
        if s == "key_str":
            if ch == '"':
                self.state = "colon"
            elif ch == "\\":
                self.state = "key_esc"
            elif ord(ch) < 0x20:
                return False
            return True
        if s == "key_esc":
            if ch in '"\\/bfnrt':
                self.state = "key_str"
                return True
            return False
        if s == "colon":
            if ch in WS:
                return True
            if ch == ":":
                self.state = "value"
                return True
            return False

        if s == "value_or_close":
            if ch in WS:
                return True
            if ch == "]":
                self.stack.pop()
                self._value_done()
                return True
            self.state = "value"
            return self.feed(ch)

        if s == "end":
            if ch in WS:
                return True
            if self.stack:
                top = self.stack[-1]
                if ch == ",":
                    self.state = "key" if top == "obj" else "value"
                    return True
                if ch == "}" and top == "obj":
                    self.stack.pop()
                    self._value_done()
                    return True
                if ch == "]" and top == "arr":
                    self.stack.pop()
                    self._value_done()
                    return True
            return False

        return False

    def _feed_num(self, ch: str) -> bool:
        s = self.state
        if s == "num_minus":
            if ch == "0":
                self.state = "num_zero"
            elif ch in "123456789":
                self.state = "num_int"
            else:
                return False
            return True
        if s == "num_zero":
            if ch == ".":
                self.state = "num_frac_dot"
            elif ch in "eE":
                self.state = "num_exp_e"
            else:
                return False
            return True
        if s == "num_int":
            if ch in DIGITS:
                return True
            if ch == ".":
                self.state = "num_frac_dot"
            elif ch in "eE":
                self.state = "num_exp_e"
            else:
                return False
            return True
        if s == "num_frac_dot":
            if ch in DIGITS:
                self.state = "num_frac"
                return True
            return False
        if s == "num_frac":
            if ch in DIGITS:
                return True
            if ch in "eE":
                self.state = "num_exp_e"
                return True
            return False
        if s == "num_exp_e":
            if ch in "+-":
                self.state = "num_exp_sign"
                return True
            if ch in DIGITS:
                self.state = "num_exp"
                return True
            return False
        if s == "num_exp_sign":
            if ch in DIGITS:
                self.state = "num_exp"
                return True
            return False
        if s == "num_exp":
            return ch in DIGITS
        return False

    def feed_text(self, text: str) -> bool:
        for ch in text:
            if not self.feed(ch):
                return False
        return True


# ---------------------------------------------------------------------------
# trie (tool names / parameter keys)
# ---------------------------------------------------------------------------


class _Trie:
    def __init__(self, words: Iterable[str]):
        self.root: Dict[str, Any] = {}
        for w in words:
            node = self.root
            for ch in w:
                node = node.setdefault(ch, {})
            node[None] = True  # terminal marker (no char collides with None)

    def step(self, node: Dict[str, Any], ch: str) -> Optional[Dict[str, Any]]:
        return node.get(ch)

    @staticmethod
    def shortest_exit(node: Dict[str, Any]) -> str:
        """First char of a shortest path from `node` to a terminal."""
        if None in node:
            return ""  # already terminal
        best_ch, best_len = "", 1 << 30

        def depth(n: Dict[str, Any]) -> int:
            if None in n:
                return 0
            return 1 + min(depth(c) for k, c in n.items() if k is not None)

        for k, child in node.items():
            if k is None:
                continue
            d = 1 + depth(child)
            if d < best_len:
                best_len, best_ch = d, k
        return best_ch


# ---------------------------------------------------------------------------
# tool-call template automaton
# ---------------------------------------------------------------------------

_HEAD = '{"name": "'
_MID = '", "parameters": {'
_TAIL = "}"


class ToolCallAutomaton:
    """Accepts exactly the canonical tool-call JSON (module docstring).

    States:
      head:<i>        inside the literal head
      name            walking the tool-name trie
      mid:<i>         inside the literal mid section
      p_key_or_close  params object: '"' (first key) or '}' (no params)
      p_key           walking the parameter-key trie (or free string)
      p_colon:<i>     the literal '": '
      p_value         inside a free JSON value (inner JsonPDA)
      p_sep:<i>       the literal ', "' between entries
      tail:<i>        the closing literal
      done            only end-of-turn may follow
    """

    # Nesting cap for free JSON parameter VALUES (JsonPDA.max_depth).
    # Shared by the host mask path and the compiled on-device FSM — the
    # two must accept the SAME language or their token streams diverge.
    # Each extra level doubles the compiled automaton's stack alphabet
    # (2^depth stack shapes), so the cap is also what keeps the
    # grammar->table compile small; 4 levels is ample for tool arguments.
    MAX_VALUE_DEPTH = 4

    def __init__(
        self,
        tools: Sequence[Dict[str, Any]],
        force_name: Optional[str] = None,
        max_value_depth: Optional[int] = None,
    ):
        self._props_by_name: Dict[str, Optional[List[str]]] = {}
        self._value_depth = (
            max_value_depth if max_value_depth is not None
            else self.MAX_VALUE_DEPTH
        )
        names = []
        for t in tools:
            fn = t.get("function", t)
            name = fn.get("name")
            if not name:
                continue
            if force_name is not None and name != force_name:
                continue
            names.append(name)
            params = fn.get("parameters") or {}
            props = list((params.get("properties") or {}).keys())
            if params.get("additionalProperties") is True or (
                not props and "properties" not in params
            ):
                # explicitly open, or no schema at all: free-form keys
                self._props_by_name[name] = None
            else:
                # declared property set (possibly empty -> params must be {})
                self._props_by_name[name] = props
        if not names:
            raise ValueError("no tools to constrain to")
        self._name_trie = _Trie(names)
        # key tries are built ONCE per tool and shared across copies so
        # that automaton-state signatures (the grammar compiler's dedup
        # key) can use trie-node identity
        self._key_tries: Dict[str, Optional[_Trie]] = {
            name: (_Trie(props) if props is not None else None)
            for name, props in self._props_by_name.items()
        }
        self.reset()

    def reset(self) -> None:
        self.state: Tuple[str, Any] = ("head", 0)
        self._name_chars: List[str] = []
        self._name_node = self._name_trie.root
        self._key_trie: Optional[_Trie] = None
        self._key_node: Optional[Dict[str, Any]] = None
        self._key_pda: Optional[JsonPDA] = None  # free-key fallback
        self._value_pda: Optional[JsonPDA] = None

    def copy(self) -> "ToolCallAutomaton":
        c = ToolCallAutomaton.__new__(ToolCallAutomaton)
        c._props_by_name = self._props_by_name
        c._name_trie = self._name_trie
        c._key_tries = self._key_tries
        c._value_depth = self._value_depth
        c.state = self.state
        c._name_chars = list(self._name_chars)
        c._name_node = self._name_node
        c._key_trie = self._key_trie
        c._key_node = self._key_node
        c._key_pda = self._key_pda.copy() if self._key_pda else None
        c._value_pda = self._value_pda.copy() if self._value_pda else None
        return c

    @property
    def done(self) -> bool:
        return self.state[0] == "done"

    def signature(self) -> Tuple:
        """Hashable identity of this automaton state (the grammar->table
        compiler's BFS dedup key).  Trie nodes are shared dicts (one node
        per unique prefix), so their id() is a sound state component;
        the PDAs contribute (stack, state, lit)."""
        def pda_sig(p: Optional[JsonPDA]):
            return None if p is None else (tuple(p.stack), p.state, p.lit)

        return (
            self.state,
            id(self._name_node),
            id(self._key_trie) if self._key_trie is not None else None,
            id(self._key_node) if self._key_node is not None else None,
            pda_sig(self._key_pda),
            pda_sig(self._value_pda),
        )

    @property
    def in_free_string(self) -> bool:
        """Inside unconstrained string content (precomputed-set fast path)."""
        kind = self.state[0]
        if kind == "p_value":
            return self._value_pda is not None and self._value_pda.in_string
        if kind == "p_key" and self._key_trie is None:
            return self._key_pda is not None and self._key_pda.state == "key_str"
        return False

    # ------------------------------------------------------------------

    def _enter_params(self) -> None:
        name = "".join(self._name_chars)
        self._key_trie = self._key_tries.get(name)
        self.state = ("p_key_or_close", None)

    def _start_key(self) -> None:
        if self._key_trie is not None:
            self._key_node = self._key_trie.root
        else:
            pda = JsonPDA()
            pda.state = "key_str"
            self._key_pda = pda
        self.state = ("p_key", None)

    def feed(self, ch: str) -> bool:  # noqa: C901
        kind, arg = self.state
        if kind == "head":
            if ch != _HEAD[arg]:
                return False
            self.state = ("name", None) if arg + 1 == len(_HEAD) else ("head", arg + 1)
            return True

        if kind == "name":
            if ch == '"':
                if None not in self._name_node:
                    return False
                self.state = ("mid", 1)  # the '"' consumed counts as _MID[0]
                return True
            nxt = self._name_trie.step(self._name_node, ch)
            if nxt is None:
                return False
            self._name_node = nxt
            self._name_chars.append(ch)
            return True

        if kind == "mid":
            if ch != _MID[arg]:
                return False
            if arg + 1 == len(_MID):
                self._enter_params()
            else:
                self.state = ("mid", arg + 1)
            return True

        if kind == "p_key_or_close":
            if ch == "}":
                self.state = ("tail", 0)
                return True
            if ch == '"':
                if self._key_trie is not None and not self._key_trie.root:
                    return False  # schema declares zero properties: {} only
                self._start_key()
                return True
            return False

        if kind == "p_key":
            if self._key_trie is not None:
                if ch == '"':
                    if None not in self._key_node:  # type: ignore[operator]
                        return False
                    self.state = ("p_colon", 0)
                    return True
                nxt = self._key_trie.step(self._key_node, ch)  # type: ignore[arg-type]
                if nxt is None:
                    return False
                self._key_node = nxt
                return True
            # free key: PDA string semantics
            assert self._key_pda is not None
            if not self._key_pda.feed(ch):
                return False
            if self._key_pda.state == "colon":  # closing quote consumed
                self._key_pda = None
                self.state = ("p_colon", 0)
            return True

        if kind == "p_colon":
            lit = ": "
            if ch != lit[arg]:
                return False
            if arg + 1 == len(lit):
                self._value_pda = JsonPDA(max_depth=self._value_depth)
                self.state = ("p_value", None)
            else:
                self.state = ("p_colon", arg + 1)
            return True

        if kind == "p_value":
            pda = self._value_pda
            assert pda is not None
            if pda.feed(ch):
                if pda.complete:
                    self._value_pda = None
                    self.state = ("p_after_value", None)
                return True
            # implicit value termination (numbers) on , or }
            if pda.would_complete and ch in ",}":
                self._value_pda = None
                self.state = ("p_after_value", None)
                return self.feed(ch)
            return False

        if kind == "p_after_value":
            if ch == ",":
                self.state = ("p_sep", 0)
                return True
            if ch == "}":
                self.state = ("tail", 0)
                return True
            return False

        if kind == "p_sep":
            lit = ' "'
            if ch != lit[arg]:
                return False
            if arg + 1 == len(lit):
                self._start_key()
            else:
                self.state = ("p_sep", arg + 1)
            return True

        if kind == "tail":
            if ch != _TAIL[arg]:
                return False
            if arg + 1 == len(_TAIL):
                self.state = ("done", None)
            else:
                self.state = ("tail", arg + 1)
            return True

        return False  # done: no further text

    def feed_text(self, text: str) -> bool:
        for ch in text:
            if not self.feed(ch):
                return False
        return True

    def wrap_char(self) -> Optional[str]:
        """Next char on a shortest path to `done` (wrap-up mode).

        With JsonPDA.max_depth bounding nesting, the distance from any
        reachable state to `done` is small and this greedy walk always
        terminates the call.  Returns None when done."""
        kind, arg = self.state
        if kind == "done":
            return None
        if kind == "head":
            return _HEAD[arg]
        if kind == "mid":
            return _MID[arg]
        if kind == "tail":
            return _TAIL[arg]
        if kind == "p_colon":
            return ": "[arg]
        if kind == "p_sep":
            # mid-separator: must finish it, then the shortest key
            return ' "'[arg]
        if kind == "name":
            return _Trie.shortest_exit(self._name_node) or '"'
        if kind == "p_key_or_close":
            return "}"
        if kind == "p_after_value":
            return "}"
        if kind == "p_key":
            if self._key_trie is not None:
                return _Trie.shortest_exit(self._key_node) or '"'  # type: ignore[arg-type]
            return '"'  # close the free key
        if kind == "p_value":
            pda = self._value_pda
            assert pda is not None
            s = pda.state
            if s == "value":
                return "0"  # minimal value
            if s == "in_str":
                return '"'
            if s == "str_esc":
                return "n"
            if s.startswith("str_u"):
                return "0"
            if s == "lit":
                return pda.lit[0]
            if s.startswith("num"):
                if s in JsonPDA._NUM_TERMINAL:
                    if pda.stack:
                        return "}" if pda.stack[-1] == "obj" else "]"
                    return "}"  # closes params via implicit value end
                return "0"
            if s == "key_or_close":
                return "}"
            if s == "key":
                return '"'
            if s in ("key_str",):
                return '"'
            if s == "key_esc":
                return "n"
            if s == "colon":
                return ":"
            if s == "value_or_close":
                return "]"
            if s == "end":
                if pda.stack:
                    return "}" if pda.stack[-1] == "obj" else "]"
                return "}"  # value complete -> params close via p_after_value
        return None

    def min_close_chars(self, limit: int = 512) -> int:
        """Characters on the shortest path from here to `done` (greedy walk
        of wrap_char; bounded because JsonPDA caps nesting)."""
        c = self.copy()
        n = 0
        while not c.done and n < limit:
            ch = c.wrap_char()
            if not ch:
                break
            if not c.feed(ch):  # pragma: no cover — wrap_char is always legal
                break
            n += 1
        return n


# ---------------------------------------------------------------------------
# tokenizer-level mask
# ---------------------------------------------------------------------------

_TOKEN_INDEX_LOCK = __import__("threading").Lock()


class TokenIndex:
    """Per-tokenizer vocab index for mask building (built once, cached)."""

    def __init__(self, tokenizer) -> None:
        self.vocab_size = tokenizer.vocab_size
        # tokenizers may pad their id space past the real token set
        # (ByteTokenizer.mask_vocab_size); padding ids are not grammar
        # tokens — indexing them would turn forced characters into fake
        # multi-option masks and break singleton-chained dispatch
        index_limit = min(
            self.vocab_size,
            getattr(tokenizer, "mask_vocab_size", self.vocab_size),
        )
        texts: List[str] = []
        for i in range(index_limit):
            try:
                texts.append(tokenizer.decode([i]))
            except Exception:
                texts.append("")
        texts.extend("" for _ in range(self.vocab_size - index_limit))
        self.texts = texts
        # longest decoded token: bounds forced_id's deterministic-run walk
        # (a single-char tokenizer never probes past one character)
        self.max_token_len = max((len(t) for t in texts), default=1)
        self.buckets: Dict[str, List[int]] = {}
        safe: List[int] = []
        for i, t in enumerate(texts):
            if not t or "�" in t:
                # specials / tokens that don't decode standalone (partial
                # UTF-8 byte tokens): excluded — the mask can only admit
                # text it can validate
                continue
            self.buckets.setdefault(t[0], []).append(i)
            if all(c not in '"\\' and ord(c) >= 0x20 for c in t):
                safe.append(i)
        self.string_safe = np.asarray(safe, np.int64)

    @classmethod
    def for_tokenizer(cls, tokenizer) -> "TokenIndex":
        """Cached build; the lock keeps a warmup thread and the first
        request from decoding the vocab twice (a 128k-vocab build is
        seconds of work — see TokenIndex.warm).

        The cache lives ON the tokenizer object: an id()-keyed dict can
        hand a NEW tokenizer the index of a garbage-collected one whose
        id the allocator reused (observed as a cross-test flake).
        """
        idx = getattr(tokenizer, "_token_index_cache", None)
        if idx is not None:
            return idx
        with _TOKEN_INDEX_LOCK:
            idx = getattr(tokenizer, "_token_index_cache", None)
            if idx is None:
                idx = cls(tokenizer)
                try:
                    tokenizer._token_index_cache = idx
                except Exception:
                    pass  # slotted/frozen tokenizer: rebuild per call
        return idx

    @classmethod
    def warm(cls, tokenizer) -> None:
        """Build the index off the event loop (daemon thread)."""
        import threading

        threading.Thread(
            target=cls.for_tokenizer, args=(tokenizer,), daemon=True,
            name="kafka-torch-token-index",
        ).start()


def _token_ok(auto: ToolCallAutomaton, text: str) -> bool:
    """Does the whole decoded token validate from this automaton state?
    (Runs PAST `done` are rejected — a token may end the call, never
    overshoot it.)"""
    c = auto.copy()
    for ch in text:
        if c.done:
            return False
        if not c.feed(ch):
            return False
    return True


def allowed_ids_for(
    auto: ToolCallAutomaton, index: TokenIndex, eot_id: int
) -> List[int]:
    """Token ids legal from `auto`'s state — THE mask semantics.

    Shared verbatim by the host mask path (ToolCallMaskFn._allowed_ids)
    and the grammar->table compiler (compile_tool_call_grammar), so the
    on-device FSM admits exactly the host path's token sets and the two
    paths emit bit-identical greedy streams.
    """
    if auto.done:
        return [eot_id]
    allowed: List[int]
    if auto.in_free_string:
        # fast path: precomputed safe set + trial-checked specials
        allowed = [int(t) for t in index.string_safe]
        for ch in ('"', "\\"):
            for tid in index.buckets.get(ch, ()):
                if _token_ok(auto, index.texts[tid]):
                    allowed.append(tid)
        return allowed
    legal = [ch for ch in PROBE_CHARS if auto.copy().feed(ch)]
    allowed = []
    for ch in legal:
        for tid in index.buckets.get(ch, ()):
            if _token_ok(auto, index.texts[tid]):
                allowed.append(tid)
    return allowed


class ToolCallMaskFn:
    """`logits_mask_fn` forcing canonical tool-call JSON (engine protocol:
    called with output_ids, returns allowed token ids or None)."""

    # extra tokens kept in hand beyond the computed shortest-close distance
    # (each close char needs at most one token)
    WRAP_UP_SLACK = 4

    def __init__(
        self,
        tokenizer,
        tools: Sequence[Dict[str, Any]],
        force_name: Optional[str] = None,
        max_tokens: Optional[int] = None,
    ):
        self._tok = tokenizer
        self._index = TokenIndex.for_tokenizer(tokenizer)
        self._auto = ToolCallAutomaton(tools, force_name=force_name)
        # kept for the on-device grammar compiler (compile_grammar_for_mask_fn)
        self.tools = list(tools)
        self.force_name = force_name
        self._consumed = 0  # output_ids already fed (incremental)
        self._fed_text_len = 0
        self._max_tokens = max_tokens
        # (text position, remaining deterministic run) memo: consecutive
        # forced_id calls slice the already-derived run instead of
        # re-probing ~98 chars per position (scheduler hot path)
        self._run_cache: Tuple[int, str] = (-1, "")

    def set_budget(self, max_tokens: int) -> None:
        """Engine hook: the token budget after window clamping.  Near its
        end the mask restricts to a shortest valid close (wrap-up), so a
        bounded generation still parses."""
        self._max_tokens = max_tokens

    def _sync(self, output_ids: List[int]) -> bool:
        """Advance the automaton to the given prefix (incremental).
        Returns False when the prefix stopped validating (degrade)."""
        if self._consumed > len(output_ids):  # new attempt/rewind
            self._auto.reset()
            self._consumed = 0
            self._fed_text_len = 0
        text = self._tok.decode(output_ids)
        delta = text[self._fed_text_len :]
        if delta:
            # generation is mask-constrained, so the delta always feeds
            if not self._auto.feed_text(delta):
                # defensive: unconstrained prefix (shouldn't happen) —
                # give up and stop constraining
                return False
            self._fed_text_len = len(text)
        self._consumed = len(output_ids)
        return True

    def _wrapping_up(self, output_ids: List[int]) -> bool:
        if self._max_tokens is None or self._auto.done:
            return False
        remaining = self._max_tokens - len(output_ids)
        return remaining <= self._auto.min_close_chars() + self.WRAP_UP_SLACK

    def __call__(self, output_ids: List[int]) -> Optional[List[int]]:
        if not self._sync(output_ids):
            return None
        if self._wrapping_up(output_ids):
            wrapped = self._wrap_up_ids()
            if wrapped:
                return wrapped
        return self._allowed_ids()

    # how far ahead a deterministic text run is grown for forced_id; the
    # canonical token picked is at most this many characters
    MAX_FORCED_RUN = 24

    def forced_id(self, output_ids: List[int]) -> Optional[int]:
        """Engine chaining hook: a single canonical token id when the
        grammar's next TEXT is deterministic, else None.

        With subword tokenizers a forced text region ("name", '": "', key
        names) admits many tokenizations, so the allowed-id mask is rarely
        a singleton even though the model has no actual choice; the host
        would then await a device round trip per token for nothing.  Here
        the deterministic character run is grown from the automaton and
        the LONGEST indexed token that prefixes it is returned — the
        engine dispatches it without awaiting the previous fetch, and the
        sampled token is overridden device-side.  Free-string content,
        genuine choice points, and wrap-up mode return None (the masked
        path decides).  For single-char tokenizers this returns exactly
        the singleton the mask would have allowed.
        """
        if not self._sync(output_ids):
            return None
        auto = self._auto
        if auto.done or auto.in_free_string:
            return None
        if self._wrapping_up(output_ids):
            return None
        cached_pos, cached_run = self._run_cache
        if cached_pos == self._fed_text_len and cached_run:
            run = cached_run
        else:
            c = auto.copy()
            run = ""
            limit = min(self.MAX_FORCED_RUN, self._index.max_token_len)
            while len(run) < limit and not c.done:
                legal: List[str] = []
                for ch in PROBE_CHARS:
                    if c.copy().feed(ch):
                        legal.append(ch)
                        if len(legal) > 1:
                            break  # choice point: no need to finish
                if len(legal) != 1:
                    break
                run += legal[0]
                c.feed(legal[0])
            if not run:
                return None
        best = None
        best_len = 0
        for tid in self._index.buckets.get(run[0], ()):
            t = self._index.texts[tid]
            if best_len < len(t) <= len(run) and run.startswith(t):
                best, best_len = tid, len(t)
        if best is not None:
            self._run_cache = (
                self._fed_text_len + best_len, run[best_len:]
            )
        return best

    def _allowed_ids(self) -> List[int]:
        return allowed_ids_for(self._auto, self._index, self._tok.eot_id)

    def state_desc(self) -> str:
        """Human-readable automaton state (over-tight-mask log lines)."""
        return repr(self._auto.state)

    def _wrap_up_ids(self) -> List[int]:
        """Allowed ids in wrap-up mode: tokens starting with the shortest
        path-to-close character that validate fully."""
        ch = self._auto.wrap_char()
        if ch is None or ch == "":
            return [self._tok.eot_id]
        out = [
            tid
            for tid in self._index.buckets.get(ch, ())
            if self._trial(tid)
        ]
        return out

    def _trial(self, token_id: int) -> bool:
        # same semantics as the compiler's trial feed — the host/device
        # mask-equality guarantee rests on sharing ONE implementation
        return _token_ok(self._auto, self._index.texts[token_id])


# ---------------------------------------------------------------------------
# on-device grammar FSM: grammar -> token-level DFA tables
# ---------------------------------------------------------------------------
#
# The host mask path above needs the previous token back on host before it
# can build the next mask — on tunneled links that is ~RTT per constrained
# token.  compile_tool_call_grammar() lowers the SAME automaton into three
# dense arrays a decode step can consume on the device with zero host
# round trips:
#
#   token_class [V] int32 — tokens partitioned into behavior classes (two
#       tokens share a class iff they behave identically from EVERY state;
#       class 0 is "illegal everywhere").  This is classic lexer-table
#       column compression: the full [S, V] transition matrix never
#       materializes — at a 128k vocab it would be gigabytes, while the
#       free-string bulk (the ~whole vocab, self-looping inside string
#       content) collapses into a handful of classes.
#   trans [S, C] int32 — state x class -> next state, -1 illegal.  The
#       per-lane allowed mask is `trans[state][token_class] >= 0`, and the
#       FSM advance after sampling is one [S, C] gather.
#   dist [S] int32 — shortest token-count from each state to `done`
#       (reverse BFS).  Near the token budget the device mask restricts to
#       distance-DECREASING transitions, the on-device analogue of the
#       host path's wrap-up mode: a bounded generation still parses.
#
# States are BFS-discovered automaton configurations, deduped by
# ToolCallAutomaton.signature(); per-state allowed sets come from
# allowed_ids_for() — the exact host-mask semantics — so the two paths
# accept identical token sets by construction.  Free-string states
# special-case the string_safe bulk as a self-loop (feeding quote-free
# safe characters never changes `in_str`), keeping the compile
# O(states x structural-tokens) instead of O(states x vocab).

GRAMMAR_ONDEVICE_ENV = "KAFKA_TORCH_GRAMMAR_ONDEVICE"
GRAMMAR_TABLE_MB_ENV = "KAFKA_TORCH_GRAMMAR_TABLE_MB"
_GRAMMAR_TABLE_MB_DEFAULT = 64
# BFS guard independent of the byte cap (a runaway grammar must fail the
# compile, not stall the process)
_GRAMMAR_MAX_STATES = 32768
# wrap-up engages when the remaining token budget is within this many
# tokens of the state's shortest close (mirrors ToolCallMaskFn's
# WRAP_UP_SLACK semantics at token granularity)
GRAMMAR_WRAP_SLACK = 4

_GRAMMAR_COMPILE_LOCK = __import__("threading").Lock()


def grammar_ondevice_enabled() -> bool:
    import os

    return os.environ.get(GRAMMAR_ONDEVICE_ENV, "1") not in (
        "0", "false", "off"
    )


def _grammar_table_cap_bytes() -> int:
    import os

    try:
        mb = float(os.environ.get(GRAMMAR_TABLE_MB_ENV, ""))
    except ValueError:
        mb = _GRAMMAR_TABLE_MB_DEFAULT
    if not mb:
        mb = _GRAMMAR_TABLE_MB_DEFAULT
    return int(mb * (1 << 20))


class CompiledGrammar:
    """Device-loadable token-level DFA for one (tools, tokenizer) pair.

    Immutable after compile; the engine registers it into its padded
    device table set (runtime/engine._GrammarTables) and lanes carry an
    int32 state advanced inside the decode step.  State 0 is the
    initial state; `-1` is the engine's "unconstrained" sentinel and never
    appears in `trans`.
    """

    __slots__ = ("token_class", "trans", "dist", "num_states",
                 "num_classes", "vocab_size", "eot_id", "max_close_tokens",
                 "wrap_slack", "schema_key")

    def __init__(self, token_class, trans, dist, vocab_size, eot_id,
                 schema_key):
        self.token_class = token_class  # np [V] int32
        self.trans = trans              # np [S, C] int32, -1 illegal
        self.dist = dist                # np [S] int32 tokens-to-done
        self.num_states = trans.shape[0]
        self.num_classes = trans.shape[1]
        self.vocab_size = vocab_size
        self.eot_id = eot_id
        self.max_close_tokens = int(dist.max()) if dist.size else 0
        # Wrap-up window: the mask flips to distance-decreasing-only when
        # budget_left <= dist + wrap_slack.  For closure the window must
        # survive the largest one-token dist INCREASE any legal
        # transition can cause (a comma at a choice point commits the
        # generation to a whole forced `, "key": v` run): while wrap is
        # NOT engaged, budget > dist + slack, and after one token
        # dist' <= dist + max_jump, budget' = budget - 1 — so
        # slack >= max_jump + 1 guarantees budget' >= dist' at engagement
        # and the restriction then closes within budget.  The host mask
        # path keeps its fixed 4-char slack and CAN still strand a tight
        # budget mid-JSON on jump-heavy schemas; the compiled path is
        # strictly more robust here (wrap timing differs only in a regime
        # where neither path claims bit-identity).
        legal = self.trans >= 0
        if legal.any():
            nd = self.dist[np.clip(self.trans, 0, self.num_states - 1)]
            jump = np.where(legal, nd - self.dist[:, None], 0)
            self.wrap_slack = max(GRAMMAR_WRAP_SLACK, int(jump.max()) + 1)
        else:  # pragma: no cover — compile refuses empty grammars
            self.wrap_slack = GRAMMAR_WRAP_SLACK
        self.schema_key = schema_key

    @property
    def table_bytes(self) -> int:
        return int(
            self.token_class.nbytes + self.trans.nbytes + self.dist.nbytes
        )

    def allowed_row(
        self, state: int, budget_left: Optional[int] = None
    ) -> np.ndarray:
        """[V] bool mask for `state` (host-side: prefill masks, tests).

        With `budget_left` (remaining token budget INCLUDING the token
        this row masks) the device wrap-up rule applies: within
        GRAMMAR_WRAP_SLACK tokens of the state's shortest close, only
        distance-decreasing transitions stay allowed — the prefill-sampled
        token then obeys the same wrap-up the decode step enforces
        (ops/sampling.grammar_allowed_mask)."""
        if state < 0:
            return np.ones(self.vocab_size, bool)
        row = self.trans[state]
        keep = row >= 0
        if budget_left is not None and (
            budget_left <= int(self.dist[state]) + self.wrap_slack
        ):
            nd = self.dist[np.clip(row, 0, self.num_states - 1)]
            wrap_keep = keep & (nd < self.dist[state])
            if wrap_keep.any():
                keep = wrap_keep
        return keep[self.token_class]

    def walk(self, tokens: Sequence[int], start: int = 0) -> int:
        """Replay a token sequence host-side (resume after preemption).
        Returns -1 (unconstrained sentinel) if the history stops
        validating — the lane then degrades rather than crashing."""
        s = start
        for t in tokens:
            if s < 0:
                return -1
            t = int(t)
            if not (0 <= t < self.vocab_size):
                return -1
            s = int(self.trans[s, self.token_class[t]])
        return s


def compile_tool_call_grammar(
    tokenizer,
    tools: Sequence[Dict[str, Any]],
    force_name: Optional[str] = None,
    vocab_size: Optional[int] = None,
    max_table_bytes: Optional[int] = None,
) -> Optional[CompiledGrammar]:
    """Lower the tool-call grammar to device tables; None = fall back to
    the host mask path (table over the size cap, an over-tight state the
    tokenizer cannot express, or an eot outside the model vocab)."""
    index = TokenIndex.for_tokenizer(tokenizer)
    eot = int(tokenizer.eot_id)
    V = int(vocab_size if vocab_size is not None else tokenizer.vocab_size)
    if not (0 <= eot < V):
        return None
    cap = (
        max_table_bytes if max_table_bytes is not None
        else _grammar_table_cap_bytes()
    )
    try:
        auto0 = ToolCallAutomaton(tools, force_name=force_name)
    except ValueError:
        return None
    safe_set = {int(t) for t in index.string_safe if int(t) < V}

    states: List[ToolCallAutomaton] = [auto0]
    sig2idx: Dict[Tuple, int] = {auto0.signature(): 0}
    sparse: List[Dict[int, int]] = []   # per state: token id -> next state
    is_string: List[bool] = []          # free-string bulk self-loop flag
    i = 0
    while i < len(states):
        auto = states[i]
        edges: Dict[int, int] = {}
        sparse.append(edges)
        is_string.append(bool(auto.in_free_string))
        if auto.done:
            edges[eot] = i  # terminal self-loop; emission stops at eot
            i += 1
            continue
        allowed = allowed_ids_for(auto, index, eot)
        explicit = (
            [t for t in allowed if int(t) not in safe_set]
            if is_string[i] else allowed
        )
        if not allowed:
            # a reachable state the tokenizer cannot advance: the device
            # path could only degrade silently — refuse to compile
            return None
        for tid in explicit:
            tid = int(tid)
            if not (0 <= tid < V):
                continue
            nxt = auto.copy()
            ok = True
            for ch in index.texts[tid]:
                if not nxt.feed(ch):
                    ok = False
                    break
            if not ok:  # pragma: no cover — allowed_ids_for vetted it
                continue
            sig = nxt.signature()
            j = sig2idx.get(sig)
            if j is None:
                j = len(states)
                if j >= _GRAMMAR_MAX_STATES:
                    return None
                sig2idx[sig] = j
                states.append(nxt)
            edges[tid] = j
        i += 1

    S = len(states)
    # ---- column compression: token behavior classes -------------------
    # key = (sorted explicit (state, next) pairs, rides-string-bulk flag);
    # the [S, V] matrix is never materialized.
    cols: Dict[int, List[Tuple[int, int]]] = {}
    for s_idx, edges in enumerate(sparse):
        for tid, nxt in edges.items():
            cols.setdefault(tid, []).append((s_idx, nxt))
    string_states = [s for s, f in enumerate(is_string) if f]
    class_of: Dict[Tuple, int] = {}
    token_class = np.zeros(V, np.int32)  # class 0 = illegal everywhere
    class_cols: List[Tuple[Tuple[Tuple[int, int], ...], bool]] = [((), False)]
    for tid in range(V):
        in_bulk = tid in safe_set and string_states
        pairs = tuple(sorted(cols.get(tid, ())))
        if not pairs and not in_bulk:
            continue  # class 0
        key = (pairs, bool(in_bulk))
        c = class_of.get(key)
        if c is None:
            c = len(class_cols)
            class_of[key] = c
            class_cols.append(key)
        token_class[tid] = c
    C = len(class_cols)
    if (S * C + V + S) * 4 > cap:
        return None
    trans = np.full((S, C), -1, np.int32)
    for c, (pairs, in_bulk) in enumerate(class_cols):
        if in_bulk:
            for s_idx in string_states:
                trans[s_idx, c] = s_idx  # free-string self-loop
        for s_idx, nxt in pairs:
            trans[s_idx, c] = nxt
    # ---- shortest token-distance to done (reverse BFS) ----------------
    import collections as _c

    INF = 1 << 30
    dist = np.full(S, INF, np.int64)
    done_states = [s for s, a in enumerate(states) if a.done]
    rev: Dict[int, List[int]] = {}
    for s_idx in range(S):
        row = trans[s_idx]
        for nxt in set(int(n) for n in row[row >= 0]):
            if nxt != s_idx:
                rev.setdefault(nxt, []).append(s_idx)
    dq = _c.deque()
    for d0 in done_states:
        dist[d0] = 0
        dq.append(d0)
    while dq:
        cur = dq.popleft()
        for prev in rev.get(cur, ()):
            if dist[prev] > dist[cur] + 1:
                dist[prev] = dist[cur] + 1
                dq.append(prev)
    if (dist >= INF).any():
        # a state that cannot reach `done` would make wrap-up mask to
        # nothing; the grammar is malformed for on-device serving
        return None
    return CompiledGrammar(
        token_class, trans, dist.astype(np.int32), V, eot,
        schema_key=_grammar_schema_key(auto0, force_name, V),
    )


def _grammar_schema_key(auto: ToolCallAutomaton, force_name, V) -> Tuple:
    return (
        tuple(sorted(
            (name, tuple(props) if props is not None else None)
            for name, props in auto._props_by_name.items()
        )),
        force_name,
        V,
    )


# Per-tokenizer compile-cache bound: a long-lived server whose requests
# carry varying tool registries (MCP merges, per-request named
# tool_choice) must not grow host RSS one multi-hundred-KB artifact per
# distinct schema forever.  dict preserves insertion order; eviction
# drops the oldest entries (in-flight requests keep their artifact alive
# by reference — eviction only forgets the cache slot).
_GRAMMAR_CACHE_MAX = 16

# Deferred background compiles: the
# grammar->table BFS walks automaton x vocab, which on a real 128k-token
# vocab takes tens of seconds.  Blocking the FIRST agent call on an
# uncached large schema for that long (even off the event loop — the
# request itself stalls) is worse than serving it through the host mask
# path, so compiles for vocabs above KAFKA_TORCH_GRAMMAR_SYNC_VOCAB run on
# a single background worker thread instead: the first call returns None
# (host path) immediately and later calls flip to on-device once the
# table lands in the cache.  Small vocabs (tests, the byte tokenizer)
# keep the synchronous path — their compiles are milliseconds.
GRAMMAR_SYNC_VOCAB_ENV = "KAFKA_TORCH_GRAMMAR_SYNC_VOCAB"
_GRAMMAR_SYNC_VOCAB_DEFAULT = 32768

_DEFER_LOCK = __import__("threading").Lock()
_DEFER_PENDING: set = set()  # (id(tokenizer), schema key) being compiled
_DEFER_QUEUE: Optional[Any] = None  # queue.Queue, created with the worker


def compile_pending() -> int:
    """Gauge: grammar compiles queued/running on the background worker
    (exported as constrained_compile_pending in /metrics)."""
    return len(_DEFER_PENDING)


def _grammar_sync_vocab() -> int:
    import os

    try:
        return int(os.environ.get(GRAMMAR_SYNC_VOCAB_ENV, "") or
                   _GRAMMAR_SYNC_VOCAB_DEFAULT)
    except ValueError:
        return _GRAMMAR_SYNC_VOCAB_DEFAULT


def _compile_into_cache(tok, mask_fn, vocab_size: int, key) -> Optional[CompiledGrammar]:
    """The locked compile-and-cache step shared by the synchronous path
    and the background worker."""
    with _GRAMMAR_COMPILE_LOCK:
        cache = getattr(tok, "_grammar_cache", None)
        if cache is None:
            cache = {}
            try:
                tok._grammar_cache = cache
            except Exception:
                cache = None  # slotted tokenizer: compile per call
        if cache is not None and key in cache:
            return cache[key]
        g = compile_tool_call_grammar(
            tok, mask_fn.tools, force_name=mask_fn.force_name,
            vocab_size=vocab_size,
        )
        if cache is not None:
            while len(cache) >= _GRAMMAR_CACHE_MAX:
                cache.pop(next(iter(cache)))
            cache[key] = g  # negative results cached too
    return g


def _defer_worker() -> None:
    import logging
    import time as _time

    from ..runtime.autoscaler import background_deferred

    log = logging.getLogger("kafka_tpu_torch.constrained")
    while True:
        tok, mask_fn, vocab_size, key = _DEFER_QUEUE.get()
        try:
            # overload degradation (autoscaler ladder rung 3): a grammar
            # compile is tens of seconds of host CPU the serving threads
            # need more — hold the queue until the overload clears (the
            # affected requests keep serving through the host mask path)
            while background_deferred():
                _time.sleep(0.25)
            _compile_into_cache(tok, mask_fn, vocab_size, key)
        except Exception as e:
            log.warning("deferred grammar compile failed: %s", e)
        finally:
            with _DEFER_LOCK:
                _DEFER_PENDING.discard((id(tok), key))


def _enqueue_deferred(tok, mask_fn, vocab_size: int, key) -> None:
    global _DEFER_QUEUE
    import queue as _queue
    import threading as _threading

    with _DEFER_LOCK:
        pkey = (id(tok), key)
        if pkey in _DEFER_PENDING:
            return  # one compile per schema, however many callers race
        _DEFER_PENDING.add(pkey)
        if _DEFER_QUEUE is None:
            _DEFER_QUEUE = _queue.Queue()
            _threading.Thread(
                target=_defer_worker, name="grammar-compile", daemon=True
            ).start()
    # the queue item holds a strong ref to tok, keeping id(tok) stable
    _DEFER_QUEUE.put((tok, mask_fn, vocab_size, key))


def compile_grammar_for_mask_fn(
    mask_fn, vocab_size: int, defer: Optional[bool] = None
) -> Optional[CompiledGrammar]:
    """Engine/provider hook: the on-device artifact for a ToolCallMaskFn
    request, or None (host fallback: disabled by env, a mask fn the
    compiler can't lower, a failed compile — all cached — or a large-
    vocab compile still in flight on the background worker).

    `defer` overrides the vocab-threshold policy (tests); None applies
    it: vocabs above KAFKA_TORCH_GRAMMAR_SYNC_VOCAB compile in the
    background and this call returns None until the table lands."""
    if not grammar_ondevice_enabled():
        return None
    if not isinstance(mask_fn, ToolCallMaskFn):
        return None  # dynamic/custom mask fns keep the host micro-batch
    tok = mask_fn._tok
    key = _grammar_schema_key(mask_fn._auto, mask_fn.force_name, vocab_size)
    cache = getattr(tok, "_grammar_cache", None)
    if cache is not None and key in cache:
        return cache[key]
    if defer is None:
        defer = vocab_size > _grammar_sync_vocab()
    if defer:
        _enqueue_deferred(tok, mask_fn, vocab_size, key)
        return None  # host-mask path now; on-device once the table lands
    return _compile_into_cache(tok, mask_fn, vocab_size, key)


def build_tool_call_mask_fn(
    tokenizer,
    tools: Sequence[Dict[str, Any]],
    tool_choice: Any = "required",
) -> Optional[ToolCallMaskFn]:
    """Resolve an OpenAI-style tool_choice into a mask fn (None = don't).

    Only "required" and {"type": "function", "function": {"name": ...}}
    constrain; "auto"/"none"/None and unrecognized values return None.  A
    forced name that matches no declared tool degrades to unconstrained
    with a warning rather than failing the request.
    """
    if not tools:
        return None
    force = None
    if isinstance(tool_choice, dict):
        force = (tool_choice.get("function") or {}).get("name")
        declared = {
            (t.get("function", t)).get("name") for t in tools
        }
        if force not in declared:
            import logging

            logging.getLogger("kafka_tpu_torch.constrained").warning(
                "tool_choice forces unknown function %r (declared: %s); "
                "falling back to unconstrained generation",
                force, sorted(n for n in declared if n),
            )
            return None
    elif tool_choice != "required":
        return None
    return ToolCallMaskFn(tokenizer, tools, force_name=force)


def validate_tool_call_json(
    text: str, tools: Sequence[Dict[str, Any]]
) -> bool:
    """Post-hoc check used by tests: parses, names a declared tool, and
    top-level parameter keys are declared properties."""
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        return False
    if not isinstance(obj, dict):
        return False
    by_name = {}
    for t in tools:
        fn = t.get("function", t)
        by_name[fn.get("name")] = fn.get("parameters") or {}
    if obj.get("name") not in by_name:
        return False
    params = obj.get("parameters")
    if not isinstance(params, dict):
        return False
    schema = by_name[obj["name"]]
    props = (schema.get("properties") or {}).keys()
    if props and schema.get("additionalProperties") is not True:
        return all(k in props for k in params)
    return True
