"""The plain reference: the programs the traffic mixes run, interpreted
step by step in plain Python.

It imports nothing of the port, of JAX or of the JAX package, and takes
nothing the port made: it parses the program's JSON5 text itself, starts
from the saved state the harness drew for an instance (the state the port
loads), and steps it as the device VM's instruction set counts steps:

- a label is no step (labels are compiled away to jump targets);
- every other task is one step; a ``goto_map`` moves to the first task
  after its target label;
- a ``parallel_race`` or ``parallel_wait`` of ``serial`` lanes is one step
  to begin, then each lane in order runs its subtasks to its end (one step
  each) and one step more to close the lane; closing the last lane leaves
  the block. No lane here waits on IO, so every lane runs, as the host
  engine's asyncio tasks do.

``export()`` writes the state in the save format the port's
``export_state`` writes: ``inserts``, ``output``, the 1-based top-level
``order_index`` of the next task, and inside a block the running lane's
cursor, keyed by the block's and the lane's command names and source line
numbers.

Integers are ``int_bits`` wide (two's complement): 32, as the
configurations state. The correctness control runs the same at 16.
"""

from __future__ import annotations

import re

__all__ = ["parse_json5", "Machine"]


# ---- a JSON5 reader for the programs' subset ------------------------------

class _Reader:
    def __init__(self, text: str):
        self.s, self.i, self.line = text, 0, 1

    def fail(self, what: str):
        raise ValueError(f"JSON5 line {self.line}: {what}")

    def skip(self) -> None:
        s = self.s
        while self.i < len(s):
            c = s[self.i]
            if c == "\n":
                self.line += 1
                self.i += 1
            elif c in " \t\r,":
                self.i += 1
            elif s.startswith("//", self.i):
                while self.i < len(s) and s[self.i] != "\n":
                    self.i += 1
            elif s.startswith("/*", self.i):
                end = s.find("*/", self.i)
                if end < 0:
                    self.fail("open comment")
                self.line += s.count("\n", self.i, end)
                self.i = end + 2
            else:
                return

    def value(self):
        self.skip()
        c = self.s[self.i]
        if c == "{":
            return self.obj()
        if c == "[":
            self.i += 1
            out = []
            while True:
                self.skip()
                if self.s[self.i] == "]":
                    self.i += 1
                    return out
                out.append(self.value())
        if c in "'\"":
            return self.string()
        m = re.compile(r"-?\d+|true|false|null").match(self.s, self.i)
        if not m:
            self.fail(f"unexpected {c!r}")
        self.i = m.end()
        words = {"true": True, "false": False, "null": None}
        return words[m.group()] if m.group() in words else int(m.group())

    def string(self) -> str:
        q, s = self.s[self.i], self.s
        self.i += 1
        out = []
        while s[self.i] != q:
            c = s[self.i]
            if c == "\\":
                self.i += 1
                c = {"n": "\n", "t": "\t"}.get(s[self.i], s[self.i])
            elif c == "\n":
                self.fail("newline in a string")
            out.append(c)
            self.i += 1
        self.i += 1
        return "".join(out)

    def obj(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.skip()
            if self.s[self.i] == "}":
                self.i += 1
                return out
            if self.s[self.i] in "'\"":
                key = self.string()
            else:
                m = re.compile(r"[A-Za-z_$][\w$]*").match(self.s, self.i)
                if not m:
                    self.fail("bad key")
                key, self.i = m.group(), m.end()
            line = self.line
            self.skip()
            if self.s[self.i] != ":":
                self.fail("expected ':'")
            self.i += 1
            out[key] = self.value()
            if key == "cmd":
                out["line"] = line


def parse_json5(text: str) -> dict:
    """The program as plain Python values; every task also gets ``line``,
    the source line of its ``cmd``."""
    reader = _Reader(text)
    value = reader.value()
    reader.skip()
    if reader.i != len(text):
        reader.fail("trailing text")
    return value


# ---- the interpreter ------------------------------------------------------

_HOLE = re.compile(r"\{(\w+)\}")
_INT = re.compile(r"-?\d+")
_TOKEN = re.compile(r"\s*(?:(\d+)|(length)\((\w+)\)|(//|[-+*%()]))")
_TOKEN_HOLES = re.compile(
    r"\s*(?:(\d+)|(length)\((\w+)\)|\{(\w+)\}|(//|[-+*%()]))")
_PREC = {"+": 1, "-": 1, "*": 2, "//": 2, "%": 2}
_ARITH = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
          "*": lambda a, b: a * b, "//": lambda a, b: a // b,
          "%": lambda a, b: a % b}
_WILDCARDS: dict = {}


def _wrap(x: int, bits: int) -> int:
    half = 1 << (bits - 1)
    return (x + half) % (1 << bits) - half


def _to_rpn(expr: str, holes: bool):
    """The expression in postfix order: ``("num", n)``, ``("hole",
    key)``, ``("len", list key)`` and ``("op", op)``; ``False`` where
    ``holes`` is asked and a hole is not a whole operand."""
    out, ops, pos = [], [], 0
    rx = _TOKEN_HOLES if holes else _TOKEN
    operand, negate = True, False      # a '-' where an operand is due
    while pos < len(expr.rstrip()):
        m = rx.match(expr, pos)
        if not m:
            if holes:
                return False
            raise ValueError(f"cannot evaluate {expr!r}")
        pos = m.end()
        if holes:
            num, fn, arg, hole, op = m.groups()
        else:
            (num, fn, arg, op), hole = m.groups(), None
        if operand and op == "-" and not negate:
            negate = True
            continue
        if negate and num is None:
            if holes:
                return False
            raise ValueError(f"cannot evaluate {expr!r}")
        operand = op is not None and op != ")"
        if num is not None:
            out.append(("num", -int(num) if negate else int(num)))
            negate = False
        elif fn:
            out.append(("len", arg))
        elif hole:
            out.append(("hole", hole))
        elif op == "(":
            ops.append(op)
        elif op == ")":
            while ops[-1] != "(":
                out.append(("op", ops.pop()))
            ops.pop()
        else:
            while ops and ops[-1] != "(" and _PREC[ops[-1]] >= _PREC[op]:
                out.append(("op", ops.pop()))
            ops.append(op)
    while ops:
        out.append(("op", ops.pop()))
    depth = 0
    for kind, _ in out:
        depth += -1 if kind == "op" else 1
        if depth < 1:
            raise ValueError(f"cannot evaluate {expr!r}")
    if depth != 1:
        raise ValueError(f"cannot evaluate {expr!r}")
    return out


def wildcard(pattern: str, text: str) -> bool:
    """Whole-string match, ``*`` standing for any run of characters."""
    rx = _WILDCARDS.get(pattern)
    if rx is None:
        rx = _WILDCARDS[pattern] = re.compile(
            ".*".join(re.escape(part) for part in pattern.split("*")), re.S)
    return rx.fullmatch(text) is not None


class Machine:
    """One program instance, stepped as the VM counts steps."""

    def __init__(self, text: str, int_bits: int = 32, state: dict = None):
        """``state``, a saved state in the port's save format with no
        cursor inside a block (``inserts``, ``output``, ``order_index``),
        is where the instance resumes; the program's default state
        otherwise."""
        program = parse_json5(text)
        self.order = program["order"]
        self.bits = int_bits
        self.labels = {t["name"]: k for k, t in enumerate(self.order)
                       if t["cmd"] == "label"}
        state = state or {"inserts": program["default_state"]["inserts"],
                          "order_index": 1}
        if set(state) - {"inserts", "output", "order_index"}:
            raise NotImplementedError("a state with a cursor in a block")
        self.inserts = {k: list(v) if isinstance(v, list) else v
                        for k, v in state["inserts"].items()}
        self.output = state.get("output", "")
        self.k = self._skip_labels(state["order_index"] - 1)  # 0-based
        self.lane = None                   # (lane, next subtask) in a block
        self._parts, self._rpn = {}, {}

    def _skip_labels(self, k: int) -> int:
        while k < len(self.order) and self.order[k]["cmd"] == "label":
            k += 1
        return k

    def text(self, template) -> str:
        if isinstance(template, int):
            return str(template)
        parts = self._parts.get(template)
        if parts is None:
            parts = self._parts[template] = _HOLE.split(template)
        if len(parts) == 1:
            return template
        out = list(parts)
        for j in range(1, len(out), 2):
            out[j] = self._str(out[j])
        return "".join(out)

    def _str(self, key: str) -> str:
        v = self.inserts[key]
        if isinstance(v, list):
            raise ValueError(f"list {key!r} interpolated into a string")
        return str(v)

    def _list(self, ref: str) -> list:
        m = _HOLE.fullmatch(ref)
        if not m or not isinstance(self.inserts.get(m.group(1)), list):
            raise ValueError(f"{ref!r} names no list")
        return list(self.inserts[m.group(1)])

    def math(self, template: str) -> int:
        """``+ - * // %`` with the usual precedence, parentheses and
        ``length(list)``, in ``int_bits`` arithmetic, over the template
        with its holes filled. A template whose holes are whole operands
        is parsed once; a hole filled with anything but an integer sends
        it the long way, through its text."""
        rpn = self._rpn.get(template)
        if rpn is None:
            rpn = self._rpn[template] = _to_rpn(template, holes=True)
        if rpn is not False:
            vals = []
            for kind, x in rpn:
                if kind == "num":
                    vals.append(_wrap(x, self.bits))
                elif kind == "hole":
                    v = self.inserts[x]
                    if isinstance(v, str) and _INT.fullmatch(v):
                        v = int(v)
                    if isinstance(v, bool) or not isinstance(v, int):
                        return self._math_text(template)
                    vals.append(_wrap(v, self.bits))
                elif kind == "len":
                    vals.append(len(self.inserts[x]))
                else:
                    b, a = vals.pop(), vals.pop()
                    vals.append(_wrap(_ARITH[x](a, b), self.bits))
            return vals[0]
        return self._math_text(template)

    def _math_text(self, template: str) -> int:
        vals = []
        for kind, x in _to_rpn(self.text(template), holes=False):
            if kind == "num":
                vals.append(_wrap(x, self.bits))
            elif kind == "len":
                vals.append(len(self.inserts[x]))
            else:
                b, a = vals.pop(), vals.pop()
                vals.append(_wrap(_ARITH[x](a, b), self.bits))
        return vals[0]

    def run_task(self, t: dict):
        """One task's effect; returns the label a ``goto_map`` jumps to."""
        cmd, ins = t["cmd"], self.inserts
        if cmd == "clear":
            self.output = ""
        elif cmd == "print":
            self.output += self.text(t["text"])
        elif cmd == "set":
            ins[t["output_name"]] = self.text(t["item"])
        elif cmd == "math":
            ins[t["output_name"]] = self.math(t["input"])
        elif cmd == "list_append":
            ins[t["output_name"]] = self._list(t["list"]) + [
                self.text(t["item"])]
        elif cmd == "list_slice":
            # 1-based and right-inclusive; a negative bound counts from
            # the end; a right bound of 0 keeps the first element
            lst = self._list(t["list"])
            lo, hi = (self.math(b) if isinstance(b, str) else b
                      for b in (t["from_index"], t["to_index"]))
            if lo == 0:
                raise ValueError("a slice's lower bound of 0")
            lo = lo - 1 if lo > 0 else len(lst) + lo
            hi = hi - 1 if hi > 0 else (len(lst) + hi if hi < 0 else 0)
            ins[t["output_name"]] = lst[lo:hi + 1]
        elif cmd == "goto_map":
            text = self.text(t["text"])
            for entry in t["target_maps"]:
                (pattern, target), = entry.items()
                if wildcard(pattern, text):
                    return target
        else:
            raise NotImplementedError(f"the reference has no {cmd!r}")
        return None

    def step(self) -> None:
        if self.k >= len(self.order):
            raise RuntimeError("the program ended inside the window")
        block = self.order[self.k]
        if self.lane is None:
            if block["cmd"] in ("parallel_race", "parallel_wait"):
                self.lane = (0, 0)
                return
            target = self.run_task(block)
            self.k = self._skip_labels(
                self.labels[target] if target else self.k + 1)
            return
        lane, sub = self.lane
        tasks = block["tasks"][lane]["tasks"]
        if sub < len(tasks):
            if self.run_task(tasks[sub]) is not None:
                raise NotImplementedError("goto_map inside a lane")
            self.lane = (lane, sub + 1)
        elif lane + 1 < len(block["tasks"]):
            self.lane = (lane + 1, 0)
        else:
            self.lane = None
            self.k = self._skip_labels(self.k + 1)

    def run(self, steps: int) -> "Machine":
        for _ in range(steps):
            self.step()
        return self

    def export(self) -> dict:
        """The state in the port's save format."""
        state = {"inserts": {k: list(v) if isinstance(v, list) else v
                             for k, v in self.inserts.items()},
                 "output": self.output, "order_index": self.k + 1}
        if self.lane is not None:
            block = self.order[self.k]
            lane, sub = self.lane
            serial = block["tasks"][lane]
            if serial["cmd"] != "serial":
                raise NotImplementedError("a lane that is not a serial")
            name = f"{block['cmd']}-{block['line']}"
            key = f"order_index/{name}/{name}/serial-{serial['line']}"
            state[key] = min(sub + 1, len(serial["tasks"]))
        return state
