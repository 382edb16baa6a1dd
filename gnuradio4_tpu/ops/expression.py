"""ExprTk-subset expression compiler → JAX (≈ reference blocks/math
ExpressionBlocks.hpp:68, which embeds the ExprTk C++ JIT).

The device inversion: instead of a bytecode interpreter per sample, the
expression is parsed once into an AST and *traced* into the XLA program —
the XLA compiler is the JIT.  Supported ExprTk subset:

- arithmetic ``+ - * / % ^`` (``^`` is power, right-associative), unary ±
- comparisons ``< <= > >= == != <>`` and logical ``and or not & |``
- ternary ``cond ? a : b`` and functional ``if(cond, a, b)``
- statements separated by ``;``; ``var name := expr`` declarations;
  assignments ``name := expr`` (also ``+= -= *= /=``), chained
  ``a := b := expr`` (right-associative)
- vector indexing ``vec[i]`` (read and write, static indices)
- ``for (var i := 0; i < N; i += 1) { … }``, ``while (cond) { … }`` and
  ``repeat … until (cond)`` loops with *static* bounds (unrolled into the
  trace — XLA sees straight-line code); data-dependent bounds raise
- in-expression aggregators ``sum/avg/min/max/mul`` — one vector argument
  reduces over it (Bulk-mode chunk axis), 2+ arguments stay elementwise
- math functions (both ExprTk and NumPy spellings) and constants pi/e/inf

- **user-defined functions** (≈ ExprTk ``symbol_table.add_function``,
  which the reference exposes through its embedded interpreter,
  ExpressionBlocks.hpp:68): ``register_function(name, fn)`` makes a
  Python/JAX callable visible inside every expression; per-expression
  tables go through ``compile_expression(..., functions={...})``. Arity
  is checked at parse time (load-time ``GrError`` on mismatch). The
  callable receives traced JAX arrays and is traced into the XLA program
  like any built-in.

- **strings** (≈ the ExprTk string type, round-5): literals ``'…'``/``"…"``,
  string variables (inputs or ``var s := '…'``), concatenation ``+``, all
  six comparisons, single-char indexing ``s[i]``, and
  ``size/lower/upper/trim/like/ilike/contains``. Strings are HOST values
  resolved at trace time — they cannot vary per sample on an XLA device —
  so a string comparison yields a host bool and
  ``mode == 'fm' ? a*x : b*x`` folds the branch at trace time (the ExprTk
  mode-switch idiom at zero runtime cost). Mixing strings into arithmetic
  raises ``GrError`` at trace time.

Explicitly NOT supported (load-time ``GrError``, never a silent misparse):
data-dependent loop bounds, and per-sample-varying strings (no XLA string
type — use the trace-time semantics above or a user function).

Recursive self-reference (ExprTk's ``y := y + 0.1*x`` IIR idiom,
ExpressionBlocks.hpp doc examples) is detected statically: if the output
variable is *read* anywhere, the per-sample program is compiled into a
``lax.scan`` over the time axis with the output as the carry.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core.errors import GrError

# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
  | (?P<str>'[^']*'|"[^"]*")
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op>:=|\+=|-=|\*=|/=|<=|>=|==|!=|<>|\|\||&&|[-+*/%^(){}\[\],;?:<>=|&])
  | (?P<ws>\s+)
  | (?P<bad>.)
""", re.VERBOSE)


def _tokenize(src: str) -> list[tuple[str, str]]:
    toks: list[tuple[str, str]] = []
    for m in _TOKEN_RE.finditer(src):
        kind = m.lastgroup
        if kind == "ws":
            continue
        if kind == "str":
            toks.append(("str", m.group()[1:-1]))
            continue
        if kind == "bad":
            raise GrError(f"expression: unexpected character {m.group()!r} "
                          f"at position {m.start()} in {src!r}")
        toks.append((kind, m.group()))
    toks.append(("end", ""))
    return toks


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclass
class Num:
    value: float


@dataclass
class Str:
    value: str


@dataclass
class Var:
    name: str


@dataclass
class BinOp:
    op: str
    lhs: Any
    rhs: Any


@dataclass
class UnOp:
    op: str
    operand: Any


@dataclass
class Ternary:
    cond: Any
    then: Any
    other: Any


@dataclass
class Call:
    name: str
    args: list


@dataclass
class Index:
    base: str
    index: Any


@dataclass
class Assign:
    target: Any      # Var or Index
    expr: Any
    declare: bool = False


@dataclass
class For:
    init: Any
    cond: Any
    step: Any
    body: list


@dataclass
class While:
    cond: Any
    body: list


@dataclass
class Repeat:          # repeat <body> until (cond)
    body: list
    cond: Any


# ---------------------------------------------------------------------------
# Parser (recursive descent, ExprTk precedence)
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, toks: list[tuple[str, str]], src: str):
        self.toks = toks
        self.i = 0
        self.src = src

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str) -> None:
        kind, val = self.next()
        if val != text:
            raise GrError(f"expression: expected {text!r}, got {val!r} "
                          f"in {self.src!r}")

    # -- statements --------------------------------------------------------

    def parse_program(self, *, stop: str = "") -> list:
        stmts: list = []
        while True:
            kind, val = self.peek()
            if kind == "end" or (stop and val == stop):
                break
            if val == ";":
                self.next()
                continue
            stmts.append(self.parse_statement())
        return stmts

    def parse_statement(self):
        kind, val = self.peek()
        if val == "var":
            self.next()
            _, name = self.next()
            self.expect(":=")
            return Assign(Var(name), self.parse_expr(), declare=True)
        if val == "for":
            return self.parse_for()
        if val == "while":
            return self.parse_while()
        if val == "repeat":
            return self.parse_repeat()
        # lookahead for assignment: NAME [índex] (:=|+=|...)
        save = self.i
        if kind == "name":
            self.next()
            target: Any = Var(val)
            if self.peek()[1] == "[":
                self.next()
                idx = self.parse_expr()
                self.expect("]")
                target = Index(val, idx)
            op = self.peek()[1]
            if op in (":=", "+=", "-=", "*=", "/="):
                self.next()
                # chained assignment a := b := expr (ExprTk := is
                # right-associative): the rhs may itself be an assignment
                rhs = self.parse_statement() if op == ":=" \
                    else self.parse_expr()
                if op != ":=":
                    read = Var(val) if isinstance(target, Var) \
                        else Index(val, target.index)
                    rhs = BinOp(op[0], read, rhs)
                return Assign(target, rhs)
            self.i = save
        return self.parse_expr()

    def parse_for(self) -> For:
        self.expect("for")
        self.expect("(")
        init = self.parse_statement()
        self.expect(";")
        cond = self.parse_expr()
        self.expect(";")
        step = self.parse_statement()
        self.expect(")")
        self.expect("{")
        body = self.parse_program(stop="}")
        self.expect("}")
        return For(init, cond, step, body)

    def parse_while(self) -> While:
        """``while (cond) { … }`` — static bounds, unrolled into the trace
        (ExprTk while-loop, ExpressionBlocks.hpp:68 embedded grammar)."""
        self.expect("while")
        self.expect("(")
        cond = self.parse_expr()
        self.expect(")")
        self.expect("{")
        body = self.parse_program(stop="}")
        self.expect("}")
        return While(cond, body)

    def parse_repeat(self) -> Repeat:
        """``repeat … until (cond)`` — body runs at least once; static
        bounds, unrolled (ExprTk repeat-until grammar)."""
        self.expect("repeat")
        body = self.parse_program(stop="until")
        self.expect("until")
        self.expect("(")
        cond = self.parse_expr()
        self.expect(")")
        return Repeat(body, cond)

    # -- expressions --------------------------------------------------------

    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        cond = self.parse_or()
        if self.peek()[1] == "?":
            self.next()
            then = self.parse_expr()
            self.expect(":")
            other = self.parse_expr()
            return Ternary(cond, then, other)
        return cond

    def parse_or(self):
        node = self.parse_and()
        while self.peek()[1] in ("or", "|", "||"):
            self.next()
            node = BinOp("or", node, self.parse_and())
        return node

    def parse_and(self):
        node = self.parse_not()
        while self.peek()[1] in ("and", "&", "&&"):
            self.next()
            node = BinOp("and", node, self.parse_not())
        return node

    def parse_not(self):
        if self.peek()[1] == "not":
            self.next()
            return UnOp("not", self.parse_not())
        return self.parse_cmp()

    def parse_cmp(self):
        node = self.parse_add()
        op = self.peek()[1]
        if op in ("<", "<=", ">", ">=", "==", "=", "!=", "<>"):
            self.next()
            node = BinOp("==" if op == "=" else op, node, self.parse_add())
        return node

    def parse_add(self):
        node = self.parse_mul()
        while self.peek()[1] in ("+", "-"):
            _, op = self.next()
            node = BinOp(op, node, self.parse_mul())
        return node

    def parse_mul(self):
        node = self.parse_unary()
        while self.peek()[1] in ("*", "/", "%"):
            _, op = self.next()
            node = BinOp(op, node, self.parse_unary())
        return node

    def parse_unary(self):
        kind, val = self.peek()
        if val in ("+", "-"):
            self.next()
            operand = self.parse_unary()
            return operand if val == "+" else UnOp("-", operand)
        return self.parse_power()

    def parse_power(self):
        base = self.parse_postfix()
        if self.peek()[1] == "^":
            self.next()
            return BinOp("^", base, self.parse_unary())  # right-assoc
        return base

    def parse_postfix(self):
        node = self.parse_atom()
        while self.peek()[1] == "[":
            if not isinstance(node, Var):
                raise GrError("expression: indexing is only supported on "
                              "named vectors")
            self.next()
            idx = self.parse_expr()
            self.expect("]")
            node = Index(node.name, idx)
        return node

    def parse_atom(self):
        kind, val = self.next()
        if kind == "num":
            return Num(float(val))
        if kind == "str":
            return Str(val)
        if val == "(":
            node = self.parse_expr()
            self.expect(")")
            return node
        if kind == "name":
            if self.peek()[1] == "(":
                self.next()
                args = []
                if self.peek()[1] != ")":
                    args.append(self.parse_expr())
                    while self.peek()[1] == ",":
                        self.next()
                        args.append(self.parse_expr())
                self.expect(")")
                return Call(val, args)
            return Var(val)
        raise GrError(f"expression: unexpected token {val!r} in {self.src!r}")


# ---------------------------------------------------------------------------
# Function / constant tables (ExprTk names + NumPy aliases for back-compat)
# ---------------------------------------------------------------------------

_STRING_FUNCTIONS: dict[str, int] = {
    "size": 1, "lower": 1, "upper": 1, "trim": 1,
    "like": 2, "ilike": 2, "contains": 2,
}


def _clamp(lo, v, hi):
    return jnp.clip(v, lo, hi)


def _if(cond, a, b):
    return jnp.where(cond, a, b)


_FUNCTIONS: dict[str, Any] = {
    # trigonometry (ExprTk + numpy spellings)
    "sin": jnp.sin, "cos": jnp.cos, "tan": jnp.tan,
    "asin": jnp.arcsin, "acos": jnp.arccos, "atan": jnp.arctan,
    "atan2": jnp.arctan2, "arcsin": jnp.arcsin, "arccos": jnp.arccos,
    "arctan": jnp.arctan, "arctan2": jnp.arctan2,
    "sinh": jnp.sinh, "cosh": jnp.cosh, "tanh": jnp.tanh,
    "sec": lambda x: 1.0 / jnp.cos(x), "csc": lambda x: 1.0 / jnp.sin(x),
    "cot": lambda x: 1.0 / jnp.tan(x),
    "deg2rad": jnp.deg2rad, "rad2deg": jnp.rad2deg,
    # exponential / rounding
    "exp": jnp.exp, "expm1": jnp.expm1, "log": jnp.log, "log10": jnp.log10,
    "log2": jnp.log2, "log1p": jnp.log1p, "sqrt": jnp.sqrt,
    "abs": jnp.abs, "floor": jnp.floor, "ceil": jnp.ceil,
    "round": jnp.round, "trunc": jnp.trunc, "sign": jnp.sign,
    "frac": lambda x: x - jnp.trunc(x),
    # min/max/clamping
    "min": jnp.minimum, "max": jnp.maximum, "minimum": jnp.minimum,
    "maximum": jnp.maximum, "clamp": _clamp,
    "clip": lambda v, lo, hi: jnp.clip(v, lo, hi),
    "inrange": lambda lo, v, hi: jnp.logical_and(lo <= v, v <= hi),
    # misc
    "pow": jnp.power, "power": jnp.power, "hypot": jnp.hypot,
    "mod": jnp.mod, "root": lambda x, n: jnp.power(x, 1.0 / n),
    "avg": lambda *a: sum(a) / len(a),
    "if": _if, "where": _if,
    # complex helpers (numpy back-compat)
    "real": jnp.real, "imag": jnp.imag, "conj": jnp.conj,
    "angle": jnp.angle,
    # elementwise multi-arg forms of the aggregator names (the one-vector
    # reducing forms are special-cased via _AGGREGATORS in Call evaluation)
    "sum": lambda *a: _sum_elem(a),
}


def _sum_elem(args):
    out = args[0]
    for x in args[1:]:
        out = out + x
    return out

_CONSTANTS = {"pi": math.pi, "e": math.e, "inf": math.inf,
              "epsilon": 2.220446049250313e-16, "true": 1.0, "false": 0.0}

# single-vector-argument reductions over the last axis (ExprTk aggregator
# forms sum(v)/avg(v)/min(v)/max(v)/mul(v); multi-arg calls stay elementwise)
_AGGREGATORS = {
    "sum": lambda v: jnp.sum(v, axis=-1),
    "avg": lambda v: jnp.mean(v, axis=-1),
    "min": lambda v: jnp.min(v, axis=-1),
    "max": lambda v: jnp.max(v, axis=-1),
    "mul": lambda v: jnp.prod(v, axis=-1),
}
_FUNCTIONS["mul"] = lambda *a: math.prod(a) if all(
    isinstance(x, (int, float)) for x in a) else _prod_elem(a)


def _prod_elem(args):
    out = args[0]
    for x in args[1:]:
        out = out * x
    return out

_MAX_UNROLL = 65536

# ---------------------------------------------------------------------------
# User-defined functions (≈ ExprTk symbol_table.add_function — the reference
# registers C++ functors into its embedded interpreter,
# ExpressionBlocks.hpp:68; here the registered Python/JAX callable is traced
# straight into the XLA program)
# ---------------------------------------------------------------------------

_KEYWORDS = {"var", "for", "while", "repeat", "until", "and", "or", "not"}

# global registry: name -> (callable, arity | None for variadic)
_USER_FUNCTIONS: dict[str, tuple[Any, int | None]] = {}


def _infer_arity(fn) -> int | None:
    """Positional-parameter count of ``fn``; None when variadic/opaque."""
    import inspect
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    n = 0
    for p in sig.parameters.values():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            return None
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            if p.default is not p.empty:
                return None          # optional args: skip the strict check
            n += 1
        elif p.default is p.empty:   # required keyword-only: not callable here
            return None
    return n


def _validated_entry(name: str, fn, arity: int | None) -> tuple[Any, int | None]:
    if not (isinstance(name, str) and name.isidentifier()):
        raise GrError(f"expression: invalid function name {name!r}")
    if name in _FUNCTIONS or name in _CONSTANTS or name in _KEYWORDS \
            or name in _AGGREGATORS:
        raise GrError(f"expression: cannot register {name!r} — it shadows a "
                      f"built-in function/constant/keyword")
    if not callable(fn):
        raise GrError(f"expression: function {name!r} is not callable")
    return (fn, _infer_arity(fn) if arity is None else int(arity))


def register_function(name: str, fn, arity: int | None = None) -> None:
    """Register a user-defined function visible inside ALL expressions
    (≈ ExprTk ``symbol_table.add_function``, ExpressionBlocks.hpp:68).

    ``fn`` receives JAX arrays/tracers positionally and must return one
    array — it is traced into the compiled XLA program. ``arity`` defaults
    to the callable's positional-parameter count and is enforced at parse
    time; pass ``arity=None`` explicitly only for introspectable
    signatures — variadic callables get no arity check."""
    _USER_FUNCTIONS[name] = _validated_entry(name, fn, arity)


def unregister_function(name: str) -> None:
    _USER_FUNCTIONS.pop(name, None)


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

def _is_concrete(v) -> bool:
    return isinstance(v, (int, float, bool)) or (
        isinstance(v, jnp.ndarray) and not isinstance(v, jax.core.Tracer)
        and v.ndim == 0)


class _Evaluator:
    def __init__(self, env: dict, src: str,
                 funcs: dict[str, tuple[Any, int | None]] | None = None):
        self.env = env
        self.src = src
        self.funcs = funcs if funcs is not None else _USER_FUNCTIONS

    def run(self, stmts: list):
        last = None
        for s in stmts:
            last = self.exec(s)
        return last

    def exec(self, node):
        if isinstance(node, Assign):
            val = self.eval(node.expr)
            if isinstance(node.target, Var):
                self.env[node.target.name] = val
            else:  # Index write on the last axis
                base = self._lookup(node.target.base)
                idx = self.eval(node.target.index)
                i = self._static_index(idx, base)
                self.env[node.target.base] = \
                    jnp.asarray(base).at[..., i].set(val)
            return val
        if isinstance(node, For):
            self.exec(node.init)
            self._loop("for", node.cond, node.body, node.step)
            return None
        if isinstance(node, While):
            self._loop("while", node.cond, node.body, None)
            return None
        if isinstance(node, Repeat):
            # body runs at least once, repeats UNTIL cond becomes true
            iters = 0
            while True:
                self.run(node.body)
                cond = self.eval(node.cond)
                if not _is_concrete(cond):
                    raise GrError(
                        "expression: repeat-until condition must be static "
                        "(loop variables and limits must be plain numbers, "
                        "not stream data — data-dependent iteration has no "
                        "static-shape XLA lowering)")
                if bool(cond):
                    break
                iters += 1
                if iters > _MAX_UNROLL:
                    raise GrError(f"expression: repeat-until exceeds "
                                  f"{_MAX_UNROLL} iterations")
            return None
        return self.eval(node)

    def _loop(self, kind: str, cond_node, body: list, step) -> None:
        iters = 0
        while True:
            cond = self.eval(cond_node)
            if not _is_concrete(cond):
                raise GrError(f"expression: {kind}-loop bounds must be "
                              f"static (loop variables and limits must "
                              f"be plain numbers, not stream data)")
            if not bool(cond):
                break
            self.run(body)
            if step is not None:
                self.exec(step)
            iters += 1
            if iters > _MAX_UNROLL:
                raise GrError(f"expression: {kind}-loop exceeds "
                              f"{_MAX_UNROLL} iterations")

    def _lookup(self, name: str):
        if name in self.env:
            return self.env[name]
        if name in _CONSTANTS:
            return _CONSTANTS[name]
        raise GrError(f"expression uses unknown name {name!r}; allowed: "
                      f"{sorted(set(self.env) | set(_CONSTANTS))} "
                      f"+ functions {sorted(_FUNCTIONS)}")

    def _static_index(self, idx, base) -> int:
        if not _is_concrete(idx):
            raise GrError("expression: vector indices must be static")
        i = int(idx)
        size = jnp.shape(jnp.asarray(base))[-1]
        if not 0 <= i < size:
            # ≈ the reference's vector_access_runtime_check
            # (ExpressionBlocks.hpp:48 handle_runtime_violation)
            raise GrError(f"expression: vector access [{i}] outside of "
                          f"[0, {size})")
        return i

    def eval(self, node):
        if isinstance(node, Assign):    # chained a := b := expr
            return self.exec(node)
        if isinstance(node, Num):
            return node.value
        if isinstance(node, Str):
            return node.value
        if isinstance(node, Var):
            return self._lookup(node.name)
        if isinstance(node, Index):
            base = self._lookup(node.base)
            if isinstance(base, str):
                # ExprTk string indexing: s[i] → one-character string
                idx = self.eval(node.index)
                if not _is_concrete(idx):
                    raise GrError("expression: string indices must be static")
                i = int(idx)
                if not 0 <= i < len(base):
                    raise GrError(f"expression: string access [{i}] outside "
                                  f"of [0, {len(base)})")
                return base[i]
            i = self._static_index(self.eval(node.index), base)
            return jnp.asarray(base)[..., i]
        if isinstance(node, UnOp):
            v = self.eval(node.operand)
            if node.op == "-":
                return -v
            return jnp.logical_not(jnp.asarray(v, bool)) \
                if not _is_concrete(v) else (not bool(v))
        if isinstance(node, BinOp):
            a, b = self.eval(node.lhs), self.eval(node.rhs)
            op = node.op
            if isinstance(a, str) or isinstance(b, str):
                return self._str_binop(op, a, b)
            if op == "+":
                return a + b
            if op == "-":
                return a - b
            if op == "*":
                return a * b
            if op == "/":
                return a / b
            if op == "%":
                return a % b
            if op == "^":
                return a ** b
            if op == "<":
                return a < b
            if op == "<=":
                return a <= b
            if op == ">":
                return a > b
            if op == ">=":
                return a >= b
            if op == "==":
                return a == b
            if op in ("!=", "<>"):
                return a != b
            if op == "and":
                return jnp.logical_and(a, b) if not (
                    _is_concrete(a) and _is_concrete(b)) \
                    else (bool(a) and bool(b))
            if op == "or":
                return jnp.logical_or(a, b) if not (
                    _is_concrete(a) and _is_concrete(b)) \
                    else (bool(a) or bool(b))
            raise GrError(f"expression: unknown operator {op!r}")
        if isinstance(node, Ternary):
            cond = self.eval(node.cond)
            if isinstance(cond, (bool, np.bool_)) or _is_concrete(cond):
                # host-decidable condition (e.g. a string comparison):
                # short-circuit like ExprTk — this also lets the branches be
                # strings, which have no XLA select
                return self.eval(node.then) if bool(cond) \
                    else self.eval(node.other)
            return _if(cond, self.eval(node.then), self.eval(node.other))
        if isinstance(node, Call):
            args = [self.eval(a) for a in node.args]
            if any(isinstance(a, str) for a in args):
                return self._str_call(node.name, args)
            # ExprTk in-expression aggregators (round-2 verdict #7): with ONE
            # vector argument, sum/avg/min/max/mul REDUCE over the vector
            # (the chunk axis in Bulk mode); with 2+ args they stay
            # elementwise, matching ExprTk's overloads
            if node.name in _AGGREGATORS and len(args) == 1:
                v = args[0]
                if not _is_concrete(v) and jnp.ndim(v) >= 1:
                    return _AGGREGATORS[node.name](jnp.asarray(v))
                if node.name == "mul":
                    return v
                return _FUNCTIONS[node.name](v, v) \
                    if node.name in ("min", "max") else v
            fn = _FUNCTIONS.get(node.name)
            if fn is None and node.name in self.funcs:
                fn = self.funcs[node.name][0]
            if fn is None and node.name in _STRING_FUNCTIONS:
                if node.name == "size":
                    # size() also works on vectors (ExprTk vector size) —
                    # but a SCALAR has no size; fail with GrError, not a
                    # bare IndexError (round-5 review finding)
                    shape = jnp.shape(jnp.asarray(args[0]))
                    if not shape:
                        raise GrError("expression: size() needs a string "
                                      "or a vector, got a scalar")
                    return float(shape[-1])
                raise GrError(f"expression: {node.name}() needs string "
                              f"arguments, got {args!r}")
            if fn is None:
                raise GrError(f"expression uses unknown function "
                              f"{node.name!r}; allowed: "
                              f"{sorted(set(_FUNCTIONS) | set(self.funcs))}")
            return fn(*args)
        raise GrError(f"expression: cannot evaluate {node!r}")

    # -- string subset (≈ ExprTk string type, ExpressionBlocks.hpp:68) -----
    # Strings are HOST values resolved at trace time (they cannot vary per
    # sample on an XLA device): literals, variables, concatenation '+',
    # the six comparisons, indexing, and the functions below. A string
    # comparison yields a host bool, so `s == 'fm' ? a*x : b*x` folds the
    # branch at trace time — the ExprTk mode-switch idiom at zero runtime
    # cost. Mixing strings into arithmetic raises at trace time.
    def _str_binop(self, op: str, a, b):
        if not (isinstance(a, str) and isinstance(b, str)):
            raise GrError(
                f"expression: operator {op!r} cannot mix a string with a "
                f"number ({a!r} {op} {b!r}); strings combine only with "
                f"strings")
        if op == "+":
            return a + b
        cmps = {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b,
                "==": a == b, "!=": a != b, "<>": a != b}
        if op in cmps:
            return bool(cmps[op])
        raise GrError(f"expression: operator {op!r} is not defined for "
                      f"strings (supported: + and comparisons)")

    def _str_call(self, name: str, args: list):
        import fnmatch
        fns = {
            "size": lambda s: float(len(s)),
            "lower": lambda s: s.lower(),
            "upper": lambda s: s.upper(),
            "trim": lambda s: s.strip(),
            # ExprTk exposes like/ilike as wildcard string matchers
            "like": lambda s, p: bool(fnmatch.fnmatchcase(s, p)),
            "ilike": lambda s, p: bool(
                fnmatch.fnmatchcase(s.lower(), p.lower())),
            "contains": lambda s, p: bool(p in s),
        }
        fn = fns.get(name)
        if fn is None:
            if name in self.funcs:      # user functions may take strings
                return self.funcs[name][0](*args)
            raise GrError(
                f"expression: function {name!r} does not accept string "
                f"arguments; string functions: {sorted(fns)}")
        try:
            return fn(*args)
        except TypeError:
            raise GrError(f"expression: {name}() called with wrong "
                          f"arguments {args!r}") from None


# ---------------------------------------------------------------------------
# Static analysis + public API
# ---------------------------------------------------------------------------

def _collect_reads(node, reads: set, writes: set,
                   funcs: dict[str, tuple[Any, int | None]] | None = None
                   ) -> None:
    if funcs is None:
        funcs = _USER_FUNCTIONS
    if isinstance(node, list):
        for n in node:
            _collect_reads(n, reads, writes, funcs)
    elif isinstance(node, Assign):
        _collect_reads(node.expr, reads, writes, funcs)
        if isinstance(node.target, Index):
            _collect_reads(node.target.index, reads, writes, funcs)
            reads.add(node.target.base)  # read-modify-write of the vector
            writes.add(node.target.base)
        else:
            writes.add(node.target.name)
    elif isinstance(node, Var):
        reads.add(node.name)
    elif isinstance(node, Index):
        reads.add(node.base)
        _collect_reads(node.index, reads, writes, funcs)
    elif isinstance(node, BinOp):
        _collect_reads(node.lhs, reads, writes, funcs)
        _collect_reads(node.rhs, reads, writes, funcs)
    elif isinstance(node, UnOp):
        _collect_reads(node.operand, reads, writes, funcs)
    elif isinstance(node, Ternary):
        for n in (node.cond, node.then, node.other):
            _collect_reads(n, reads, writes, funcs)
    elif isinstance(node, Call):
        if node.name not in _FUNCTIONS and node.name not in funcs \
                and node.name not in _STRING_FUNCTIONS:
            allowed = sorted(set(_FUNCTIONS) | set(funcs)
                             | set(_STRING_FUNCTIONS))
            raise GrError(f"expression uses unknown function {node.name!r}; "
                          f"allowed: {allowed}")
        if node.name in _STRING_FUNCTIONS \
                and node.name not in _FUNCTIONS and node.name not in funcs \
                and len(node.args) != _STRING_FUNCTIONS[node.name]:
            raise GrError(
                f"expression: {node.name}() takes "
                f"{_STRING_FUNCTIONS[node.name]} argument(s), called with "
                f"{len(node.args)}")
        if node.name in funcs:
            # parse-time arity check (≈ ExprTk's compile error on a
            # wrong-arity call into a registered function)
            arity = funcs[node.name][1]
            if arity is not None and len(node.args) != arity:
                raise GrError(
                    f"expression: user function {node.name!r} takes "
                    f"{arity} argument{'s' if arity != 1 else ''}, "
                    f"called with {len(node.args)}")
        for n in node.args:
            _collect_reads(n, reads, writes, funcs)
    elif isinstance(node, For):
        for n in (node.init, node.cond, node.step):
            _collect_reads(n, reads, writes, funcs)
        _collect_reads(node.body, reads, writes, funcs)
    elif isinstance(node, While):
        _collect_reads(node.cond, reads, writes, funcs)
        _collect_reads(node.body, reads, writes, funcs)
    elif isinstance(node, Repeat):
        _collect_reads(node.body, reads, writes, funcs)
        _collect_reads(node.cond, reads, writes, funcs)


class CompiledExpression:
    """A parsed ExprTk-subset program, callable with named inputs.

    ``out_var``: value returned is the last assignment to this variable if
    the program assigns it, else the value of the last statement (the
    ExprTk convention: ``y := a*x`` and bare ``a*x`` are equivalent).
    ``reads_output`` is True when the program reads ``out_var`` — the
    recursive-IIR idiom requiring a scan over time.
    """

    def __init__(self, src: str, arg_names: tuple[str, ...],
                 out_var: str = "y",
                 functions: dict[str, Any] | None = None):
        self.src = src
        self.arg_names = arg_names
        self.out_var = out_var
        # effective function table = global registry overlaid with the
        # per-expression table (≈ ExprTk: one symbol_table per expression,
        # ExpressionBlocks.hpp:68). Snapshotted at compile time so later
        # registry mutation can't silently change a compiled program.
        self.functions: dict[str, tuple[Any, int | None]] = \
            dict(_USER_FUNCTIONS)
        for fname, fv in (functions or {}).items():
            fn, arity = fv if isinstance(fv, tuple) else (fv, None)
            self.functions[fname] = _validated_entry(fname, fn, arity)
        self.stmts = _Parser(_tokenize(src), src).parse_program()
        if not self.stmts:
            raise GrError(f"expression: empty program in {src!r}")
        reads: set = set()
        self.writes: set = set()
        _collect_reads(self.stmts, reads, self.writes, self.functions)
        known = set(arg_names) | set(_CONSTANTS) | self.writes | {out_var}
        unknown = reads - known
        if unknown:
            raise GrError(f"expression uses unknown name "
                          f"{sorted(unknown)[0]!r}; allowed: "
                          f"{sorted(set(arg_names) | set(_CONSTANTS))} "
                          f"+ functions {sorted(_FUNCTIONS)}")
        self.reads_output = (out_var in reads) and (out_var not in arg_names)

    def __call__(self, **inputs):
        env = dict(inputs)
        ev = _Evaluator(env, self.src, self.functions)
        last = ev.run(self.stmts)
        if self.out_var in self.writes:
            return env[self.out_var]
        return last

    def eval_all(self, **inputs) -> tuple[Any, dict]:
        """Run the program and return ``(result, {written_var: value})`` —
        the multi-output form (ExprTk programs may assign several result
        variables; each written name can feed its own output port)."""
        env = dict(inputs)
        ev = _Evaluator(env, self.src, self.functions)
        last = ev.run(self.stmts)
        result = env[self.out_var] if self.out_var in self.writes else last
        return result, {k: env[k] for k in self.writes if k in env}


def compile_expression(src: str, arg_names: tuple[str, ...],
                       out_var: str = "y",
                       functions: dict[str, Any] | None = None
                       ) -> CompiledExpression:
    """Parse + statically check an ExprTk-subset expression.

    ``functions`` maps extra names to Python/JAX callables (or
    ``(callable, arity)`` tuples) visible inside this expression only,
    layered over the global ``register_function`` registry."""
    return CompiledExpression(src, arg_names, out_var=out_var,
                              functions=functions)
