"""The fused neighbor-reduce (K3): the user's per-pair callback summed
over each query's exact neighbor set, compiled into a CUDA kernel.

PyTorch counterpart of the reduce mode of
``treensearch_tpu/ops/pallas_pairs.py::make_pairs_call(reduce_fn=...)``
(``:671-777``) and of ``fastpath.ReduceSpec`` (``fastpath.py:160-176``).

The callback ``fn(env)`` is one Python function that runs both ways:

- on the CPU (``pairs_reduce_plain``) it is called with real float32 and
  int32 tensors, (tiles, 128, candidates) wide;
- for the card it is called once with ``Traced`` values, which record
  every operation; ``cuda_body`` writes the record as CUDA C++ into the
  generated section of ``csrc/reduce.cu``, and the result is built by
  ``nvcc`` into ``build/reduce_<hash>.so``, keyed by the hash of the
  generated source and the flags: one expression builds once, in and
  across processes (the counterpart of JAX's compile cache, keyed by
  content rather than by the identity of ``fn``).

The env is JAX's: ``dx dy dz`` (candidate minus query), ``d2``, ``r2_i``
(the square of the query's F_R field, so 0 at a fixed radius, as in JAX),
``orig_i orig_j set_i set_j`` (int), ``p0_i p1_i p0_j p1_j`` (the
payload), plus ``r_j`` in variable mode.  What a traced callback may do:
``+ - * /``, unary ``-``, ``**`` by -2, -1, 0, 1, 2, 3 or 0.5 (the
exponents eager PyTorch evaluates by products, division and ``sqrt``),
comparisons, ``&``, ``|`` and ``~`` on booleans, ``torch.where``,
``sqrt``, ``rsqrt``, ``exp``, ``abs``, ``minimum``, ``maximum``,
``clamp``, ``ones_like``, ``zeros_like``, ``full_like``, ``.float()``, and
Python and numpy scalars.  Types follow PyTorch's promotion with every
int 32 bits wide: int with float is float, ``/`` is float, a scalar takes
the tensor's type within its kind.  Each output is cast to float32, as
the JAX kernel casts with ``.astype(jnp.float32)``.  Anything else raises
``TypeError`` naming the operation, as does returning another number of
outputs than ``n_out``; there is no fallback to the plain version on the
card.  Float arithmetic is emitted as ``__fadd_rn``/``__fsub_rn``/
``__fmul_rn``/``__fdiv_rn``/``__fsqrt_rn``, so each pair's value rounds as
eager PyTorch rounds it (``exp`` and ``rsqrt`` may differ by an ulp);
only the order of the sum differs.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from . import pairs as P

TEMPLATE = Path(__file__).resolve().parent.parent / "csrc" / "reduce.cu"
_GEN_BEGIN = "// ---- generated section (ops/reduce.py) ----\n"
_GEN_END = "// ---- end of generated section ----\n"
MAX_OUT = 8


@dataclass(frozen=True)
class ReduceSpec:
    """The fused reduce's callback: ``fn(env)`` returns ``n_out`` (1 to 8)
    values per pair, each summed in float32 over the query's neighbors;
    ``has_payload`` says whether a payload rides the records' p0/p1
    fields (they are 0 without one)."""
    fn: Callable
    n_out: int
    has_payload: bool = False


FLOAT_ENV = ("dx", "dy", "dz", "d2", "r2_i", "p0_i", "p1_i", "p0_j", "p1_j")
INT_ENV = ("orig_i", "orig_j", "set_i", "set_j")

# ------------------------------------------------------------------ tracing
_B, _I, _F = "b", "i", "f"                 # bool, int32, float32
_RANK = {_B: 0, _I: 1, _F: 2}
_DTYPE = {_B: torch.bool, _I: torch.int32, _F: torch.float32}
_KIND_OF_DTYPE = {v: k for k, v in _DTYPE.items()}
_INT32 = (-(1 << 31), (1 << 31) - 1)


class Traced:
    """A value of the traced callback: a node of the expression graph
    (``op`` on ``args``, of kind bool, int32 or float32)."""

    __slots__ = ("op", "args", "kind", "value")
    __array_ufunc__ = None     # numpy scalars defer to the reflected ops
    __hash__ = object.__hash__

    def __init__(self, op: str, args: tuple, kind: str, value=None):
        self.op, self.args, self.kind, self.value = op, args, kind, value

    def __repr__(self):
        return f"Traced({self.op}, kind={self.kind})"

    # arithmetic
    def __add__(self, o):
        return _arith("add", self, o)

    def __radd__(self, o):
        return _arith("add", o, self)

    def __sub__(self, o):
        return _arith("sub", self, o)

    def __rsub__(self, o):
        return _arith("sub", o, self)

    def __mul__(self, o):
        return _arith("mul", self, o)

    def __rmul__(self, o):
        return _arith("mul", o, self)

    def __truediv__(self, o):
        return _arith("div", self, o)

    def __rtruediv__(self, o):
        # PyTorch takes scalar / tensor as tensor.reciprocal() * scalar
        return _arith("mul", _arith("div", 1, self), o)

    def __neg__(self):
        if self.kind == _B:
            raise TypeError("traced callback: negation of a boolean")
        return Traced("neg", (self,), self.kind)

    def __pow__(self, e):
        return _pow(self, e)

    # comparisons and logic
    def __lt__(self, o):
        return _compare("lt", self, o)

    def __le__(self, o):
        return _compare("le", self, o)

    def __gt__(self, o):
        return _compare("gt", self, o)

    def __ge__(self, o):
        return _compare("ge", self, o)

    def __eq__(self, o):
        return _compare("eq", self, o)

    def __ne__(self, o):
        return _compare("ne", self, o)

    def __and__(self, o):
        return _logic("and", self, o)

    __rand__ = __and__

    def __or__(self, o):
        return _logic("or", self, o)

    __ror__ = __or__

    def __invert__(self):
        if self.kind != _B:
            raise TypeError("traced callback: ~ is supported on booleans "
                            "only")
        return Traced("not", (self,), _B)

    # methods
    def float(self):
        return _cast(self, _F)

    def sqrt(self):
        return _unary_float("sqrt", self)

    def rsqrt(self):
        return _unary_float("rsqrt", self)

    def exp(self):
        return _unary_float("exp", self)

    def abs(self):
        return _abs(self)

    def clamp(self, min=None, max=None):
        return _clamp(self, min, max)

    # what a traced value cannot be
    def _refuse(self, what):
        raise TypeError(f"traced callback: {what} of a traced value is not "
                        "supported (the callback runs once, symbolically, "
                        "for the card)")

    def __bool__(self):
        self._refuse("bool() (Python control flow)")

    def __float__(self):
        self._refuse("float()")

    def __int__(self):
        self._refuse("int()")

    def __index__(self):
        self._refuse("use as an index")

    def __len__(self):
        self._refuse("len()")

    def __iter__(self):
        self._refuse("iteration")

    def __getitem__(self, k):
        self._refuse("indexing")

    def __getattr__(self, name):
        if name.startswith("_"):   # protocol probes (numpy, copy, ...)
            raise AttributeError(name)
        raise TypeError(f"traced callback: the operation '{name}' is not "
                        "supported")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        impl = _TORCH_FUNCS.get(func)
        if impl is None:
            name = getattr(func, "__name__", repr(func))
            raise TypeError(f"traced callback: the operation '{name}' is "
                            "not supported")
        return impl(*args, **(kwargs or {}))


def _scalar_kind(x):
    if isinstance(x, (bool, np.bool_)):
        return _B
    if isinstance(x, (int, np.integer)):
        return _I
    if isinstance(x, (float, np.floating)):
        return _F
    return None


def _const(v, kind: str) -> Traced:
    if kind == _F:
        v = float(np.float32(v))   # as PyTorch casts a scalar into float32
    elif kind == _I:
        v = int(v)
        if not _INT32[0] <= v <= _INT32[1]:
            raise TypeError(f"traced callback: integer {v} does not fit "
                            "int32")
    else:
        v = bool(v)
    return Traced("const", (), kind, v)


def _lift(x, what: str) -> Traced:
    if isinstance(x, Traced):
        return x
    kind = _scalar_kind(x)
    if kind is None:
        raise TypeError(f"traced callback: '{what}' with an operand of type "
                        f"{type(x).__name__} is not supported (a callback "
                        "takes the env's values and Python or numpy "
                        "scalars)")
    return _const(x, kind)


def _cast(x: Traced, kind: str) -> Traced:
    if x.kind == kind:
        return x
    if x.op == "const":
        return _const(x.value, kind)
    return Traced("cast", (x,), kind)


def _common(*xs: Traced) -> str:
    return max((x.kind for x in xs), key=_RANK.get)


def _arith(op: str, a, b) -> Traced:
    a, b = _lift(a, op), _lift(b, op)
    if a.kind == _B and b.kind == _B:
        raise TypeError(f"traced callback: '{op}' of two booleans is not "
                        "supported")
    kind = _F if op == "div" else _common(a, b)
    return Traced(op, (_cast(a, kind), _cast(b, kind)), kind)


def _compare(op: str, a, b) -> Traced:
    a, b = _lift(a, op), _lift(b, op)
    kind = _common(a, b)
    return Traced(op, (_cast(a, kind), _cast(b, kind)), _B)


def _logic(op: str, a, b) -> Traced:
    a, b = _lift(a, op), _lift(b, op)
    if a.kind != _B or b.kind != _B:
        raise TypeError(f"traced callback: '{op}' is supported on booleans "
                        "only")
    return Traced(op, (a, b), _B)


def _unary_float(op: str, x) -> Traced:
    x = _lift(x, op)
    return Traced(op, (_cast(x, _F),), _F)


def _abs(x) -> Traced:
    x = _lift(x, "abs")
    if x.kind == _B:
        raise TypeError("traced callback: abs of a boolean")
    return Traced("abs", (x,), x.kind)


def _minmax(op: str, a, b) -> Traced:
    if not (isinstance(a, Traced) and isinstance(b, Traced)):
        raise TypeError(f"traced callback: '{op}imum' takes two traced "
                        "values (use clamp for a scalar bound)")
    kind = _common(a, b)
    if kind == _B:
        raise TypeError(f"traced callback: '{op}imum' of booleans")
    return Traced(op, (_cast(a, kind), _cast(b, kind)), kind)


def _clamp(x, min=None, max=None) -> Traced:
    x = _lift(x, "clamp")
    if min is None and max is None:
        raise TypeError("traced callback: clamp needs min or max")
    bounds = [_lift(v, "clamp") for v in (min, max) if v is not None]
    kind = _common(x, *bounds)
    if kind == _B:
        raise TypeError("traced callback: clamp of a boolean")
    out = _cast(x, kind)
    if min is not None:
        out = Traced("max", (out, _cast(_lift(min, "clamp"), kind)), kind)
    if max is not None:
        out = Traced("min", (out, _cast(_lift(max, "clamp"), kind)), kind)
    return out


def _where(cond, a, b) -> Traced:
    if not (isinstance(cond, Traced) and cond.kind == _B):
        raise TypeError("traced callback: torch.where needs a traced boolean "
                        "condition")
    a, b = _lift(a, "where"), _lift(b, "where")
    kind = _common(a, b)
    return Traced("where", (cond, _cast(a, kind), _cast(b, kind)), kind)


def _pow(x: Traced, e) -> Traced:
    """``x ** e`` as eager PyTorch evaluates these exponents: by products,
    a division or ``sqrt`` (a float exponent makes an int base float)."""
    e_kind = None if isinstance(e, Traced) else _scalar_kind(e)
    if e_kind not in (_I, _F) \
            or float(e) not in (-2.0, -1.0, 0.0, 1.0, 2.0, 3.0, 0.5):
        raise TypeError(f"traced callback: '**' by {e!r} is not supported "
                        "(exponents -2, -1, 0, 1, 2, 3 and 0.5 are)")
    if x.kind == _B:
        raise TypeError("traced callback: '**' of a boolean")
    e = float(e)
    x = _cast(x, _F if e_kind == _F else x.kind)
    if e == 0.5:
        return _unary_float("sqrt", x)
    if e < 0:
        if x.kind != _F:
            raise TypeError("traced callback: an integer to a negative "
                            "power")
        return _arith("div", 1.0, x if e == -1 else x * x)
    if e == 0:
        return _const(1, x.kind)
    if e == 1:
        return x
    return x * x if e == 2 else (x * x) * x


def _like(x, fill, dtype=None) -> Traced:
    if not isinstance(x, Traced):
        raise TypeError("traced callback: *_like needs a traced value")
    kind = x.kind if dtype is None else _KIND_OF_DTYPE.get(dtype)
    if kind is None:
        raise TypeError(f"traced callback: dtype {dtype} is not supported "
                        "(float32, int32 or bool)")
    if _scalar_kind(fill) is None:
        raise TypeError("traced callback: full_like needs a scalar fill")
    if kind == _I:
        fill = int(fill)   # PyTorch truncates a float fill into an int
    return _const(fill, kind)


def _like_kwargs(kw) -> dict:
    dtype = kw.pop("dtype", None)
    if kw:
        raise TypeError("traced callback: *_like takes only dtype, got "
                        f"{sorted(kw)}")
    return {"dtype": dtype}


_TORCH_FUNCS = {
    torch.where: _where,
    torch.sqrt: lambda x: _unary_float("sqrt", x),
    torch.rsqrt: lambda x: _unary_float("rsqrt", x),
    torch.exp: lambda x: _unary_float("exp", x),
    torch.abs: _abs,
    torch.minimum: lambda a, b: _minmax("min", a, b),
    torch.maximum: lambda a, b: _minmax("max", a, b),
    torch.clamp: _clamp,
    torch.ones_like: lambda x, **kw: _like(x, 1, **_like_kwargs(kw)),
    torch.zeros_like: lambda x, **kw: _like(x, 0, **_like_kwargs(kw)),
    torch.full_like: lambda x, v, **kw: _like(x, v, **_like_kwargs(kw)),
}


def env_names(variable: bool) -> tuple:
    return FLOAT_ENV + INT_ENV + (("r_j",) if variable else ())


def trace(spec: ReduceSpec, variable: bool) -> tuple:
    """The callback's outputs as ``Traced`` float32 nodes, one per output.
    Raises ``TypeError`` for an unsupported operation or arity."""
    env = {k: Traced("var", (), _I if k in INT_ENV else _F, k)
           for k in env_names(variable)}
    outs = _as_outputs(spec.fn(env), spec.n_out)
    return tuple(_cast(_lift(o, "output"), _F) for o in outs)


def _as_outputs(outs, n_out: int) -> tuple:
    if not isinstance(outs, (tuple, list)):
        outs = (outs,)
    if len(outs) != n_out:
        raise TypeError(f"reduce callback returned {len(outs)} outputs, "
                        f"n_out is {n_out}")
    return tuple(outs)


def _topo(outputs) -> list:
    """Every node the outputs depend on, each once, operands first."""
    order, seen = [], set()

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for a in node.args:
            visit(a)
        order.append(node)

    for o in outputs:
        visit(o)
    return order


# ------------------------------------------------------------ CUDA emission
_C_TYPE = {_B: "bool", _I: "int", _F: "float"}
_F_BIN = {"add": "__fadd_rn", "sub": "__fsub_rn", "mul": "__fmul_rn",
          "div": "__fdiv_rn"}
_F_UNARY = {"sqrt": "__fsqrt_rn", "rsqrt": "__frsqrt_rn", "exp": "expf"}
_I_BIN = {"add": "+", "sub": "-", "mul": "*"}
_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_LOGIC = {"and": "&&", "or": "||"}


def _c_const(node: Traced) -> str:
    if node.kind == _F:
        bits = int(np.array(node.value, np.float32).view(np.uint32))
        return f"__int_as_float(0x{bits:08x})"
    if node.kind == _I:
        return f"({node.value + 1} - 1)" if node.value == _INT32[0] \
            else f"({node.value})"
    return "true" if node.value else "false"


def _c_expr(node: Traced, a: list) -> str:
    """One operation as a CUDA expression of its operands ``a``."""
    op, k = node.op, node.kind
    if op in _F_BIN and k == _F:
        return f"{_F_BIN[op]}({a[0]}, {a[1]})"
    if op in _I_BIN:   # int32 wraps as in PyTorch
        return f"(int)((unsigned){a[0]} {_I_BIN[op]} (unsigned){a[1]})"
    if op in _CMP:
        return f"({a[0]} {_CMP[op]} {a[1]})"
    if op in _LOGIC:
        return f"({a[0]} {_LOGIC[op]} {a[1]})"
    if op in _F_UNARY:
        return f"{_F_UNARY[op]}({a[0]})"
    if op in ("min", "max"):
        return f"tns_f{op}({a[0]}, {a[1]})" if k == _F \
            else f"{op}({a[0]}, {a[1]})"
    if op == "cast":
        if k == _F:
            return f"__int2float_rn({a[0]})" if node.args[0].kind == _I \
                else f"({a[0]} ? 1.0f : 0.0f)"
        return f"(int){a[0]}" if k == _I else f"({a[0]} != 0)"
    if op == "where":
        return f"({a[0]} ? {a[1]} : {a[2]})"
    if op == "not":
        return f"(!{a[0]})"
    neg = f"(int)(0u - (unsigned){a[0]})"
    if op == "neg":
        return f"(-{a[0]})" if k == _F else neg
    if op == "abs":
        return f"fabsf({a[0]})" if k == _F else f"({a[0]} < 0 ? {neg} : {a[0]})"
    raise AssertionError(f"no CUDA form for {op}")


def cuda_body(outputs) -> tuple:
    """CUDA statements of ``pair_fn``'s body for traced outputs: one
    ``const`` temporary per operation, in dependency order, then ``v[k]``.
    Returns (source, the env names read, the number of operations)."""
    names, lines, used = {}, [], set()
    for node in _topo(outputs):
        if node.op == "var":
            names[id(node)] = node.value
            used.add(node.value)
        elif node.op == "const":
            names[id(node)] = _c_const(node)
        else:
            t = f"t{len(lines)}"
            expr = _c_expr(node, [names[id(x)] for x in node.args])
            lines.append(f"  const {_C_TYPE[node.kind]} {t} = {expr};")
            names[id(node)] = t
    lines += [f"  v[{k}] = {names[id(o)]};" for k, o in enumerate(outputs)]
    n_ops = sum(1 for n in _topo(outputs) if n.op not in ("var", "const"))
    return "\n".join(lines) + "\n", used, n_ops


@functools.lru_cache(maxsize=1)
def _template() -> str:
    """``csrc/reduce.cu``, read once per process (each ``run_reduce``
    call generates a source from it)."""
    return TEMPLATE.read_text()


def kernel_source(spec: ReduceSpec, variable: bool) -> tuple:
    """``csrc/reduce.cu`` with its generated section written for this
    callback.  Returns (source text, traced operations per pair)."""
    body, used, n_ops = cuda_body(trace(spec, variable))
    params = ",\n    ".join(
        f"{'int' if k in INT_ENV else 'float'} {k}"
        for k in FLOAT_ENV[:5] + INT_ENV + FLOAT_ENV[5:] + ("r_j",))
    gen = (f"constexpr int N_OUT = {spec.n_out};\n"
           f"constexpr bool VARIABLE = {str(variable).lower()};\n"
           + "".join(f"constexpr bool USE_{k.upper()} = "
                     f"{str(k in used).lower()};\n"
                     for k in ("set_j", "p0_j", "p1_j", "r_j"))
           + "__device__ __forceinline__ void pair_fn(\n"
           f"    {params},\n    float (&v)[N_OUT]) {{\n{body}}}\n")
    head, rest = _template().split(_GEN_BEGIN)
    _, tail = rest.split(_GEN_END)
    return head + _GEN_BEGIN + gen + _GEN_END + tail, n_ops


# ------------------------------------------------------------ interpreter
def evaluate(outputs, env: dict) -> tuple:
    """The traced outputs evaluated with eager PyTorch on ``env``'s tensors,
    operation by operation as the generated CUDA computes them (the
    tracer's own check on the CPU)."""
    val = {}
    unary = {"neg": torch.neg, "not": torch.logical_not, "sqrt": torch.sqrt,
             "rsqrt": torch.rsqrt, "exp": torch.exp, "abs": torch.abs}
    binary = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
              "div": torch.div, "lt": torch.lt, "le": torch.le,
              "gt": torch.gt, "ge": torch.ge, "eq": torch.eq, "ne": torch.ne,
              "and": torch.logical_and, "or": torch.logical_or,
              "min": torch.minimum, "max": torch.maximum}
    for node in _topo(outputs):
        a = [val[id(x)] for x in node.args]
        if node.op == "var":
            v = env[node.value]
        elif node.op == "const":
            v = torch.tensor(node.value, dtype=_DTYPE[node.kind])
        elif node.op == "cast":
            v = a[0].to(_DTYPE[node.kind])
        elif node.op == "where":
            v = torch.where(*a)
        elif node.op in unary:
            v = unary[node.op](a[0])
        else:
            v = binary[node.op](*a)
        val[id(node)] = v
    return tuple(val[id(o)] for o in outputs)


# ------------------------------------------------------------ K3
def _check_spec(spec: ReduceSpec) -> None:
    if not isinstance(spec, ReduceSpec) or not callable(spec.fn) \
            or not 1 <= int(spec.n_out) <= MAX_OUT:
        raise ValueError(f"a ReduceSpec with a callable and 1 <= n_out <= "
                         f"{MAX_OUT}, got {spec!r}")


def pairs_reduce_plain(desc: torch.Tensor, q_t: torch.Tensor,
                       recs_t: torch.Tensor, n_win: int, tiles_cap: int,
                       spec: ReduceSpec, cand_sets, allow: torch.Tensor,
                       r2: float | None = None,
                       symmetric: bool = False) -> torch.Tensor:
    """Plain version of K3: ``spec.fn`` on the env tensors of every
    candidate of ``pairs._plain_chunks`` (K2's window clip, criterion and
    self exclusion), summed over the hits that the active matrix keeps
    (``pairs.allow_bits``).  Returns (n_out, tiles_cap * 128) float32,
    zero for dead tiles and sentinel lanes."""
    out = torch.zeros((spec.n_out, tiles_cap * P.TILE), dtype=torch.float32,
                      device=desc.device)
    f32 = P.f32_field
    for ch in P._plain_chunks(desc, q_t, recs_t, n_win, tiles_cap, r2,
                              symmetric):
        qr = ch.query(f32(q_t, P.F_R))
        env = {"dx": ch.dx, "dy": ch.dy, "dz": ch.dz, "d2": ch.d2,
               "r2_i": qr * qr,
               "orig_i": ch.query(q_t[P.F_ORIG]),
               "orig_j": ch.cand(recs_t[P.F_ORIG]),
               "set_i": ch.query(q_t[P.F_SET]),
               "set_j": ch.cand(recs_t[P.F_SET]),
               "p0_i": ch.query(f32(q_t, 6)), "p1_i": ch.query(f32(q_t, 7)),
               "p0_j": ch.cand(f32(recs_t, 6)),
               "p1_j": ch.cand(f32(recs_t, 7))}
        if r2 is None:
            env["r_j"] = ch.cand(f32(recs_t, P.F_R))
        hit = ch.hit & P.allow_bits(ch, q_t, recs_t, cand_sets, allow)
        for k, v in enumerate(_as_outputs(spec.fn(env), spec.n_out)):
            v = torch.as_tensor(v, device=desc.device).to(torch.float32)
            out[k, ch.t0 * P.TILE:ch.t1 * P.TILE] = torch.where(
                hit, v, 0.0).sum(dim=2).reshape(-1)
    return out


def reduce_library(spec: ReduceSpec, variable: bool):
    """K3 built for this callback and radius mode (``build_library``'s
    cache by content), its build time printed when ``nvcc`` ran.  Traces
    first, so an unsupported operation raises before any build."""
    text, _ = kernel_source(spec, variable)
    loaded = P.build_library("reduce", text.encode())
    if not loaded.configured:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = loaded.lib.tns_pairs_reduce
        fn.argtypes = [vp, vp, vp, ci, ci, ci, cf, ci, ci,
                       ctypes.POINTER(ci), vp, ci, vp, vp]
        fn.restype = ci
        loaded.configured = True
        if loaded.command:
            print(f"pairs_reduce: nvcc {loaded.seconds:.2f} s -> "
                  f"{loaded.path.name}", file=sys.stderr, flush=True)
    return loaded


def pairs_reduce(desc: torch.Tensor, q_t: torch.Tensor, recs_t: torch.Tensor,
                 n_win: int, tiles_cap: int, spec: ReduceSpec, cand_sets,
                 allow: torch.Tensor, r2: float | None = None,
                 symmetric: bool = False) -> torch.Tensor:
    """K3: each slot's n_out sums (n_out, tiles_cap * 128) float32 of
    ``spec.fn`` over its exact neighbor set under the active matrix
    (``pairs.check_active_args`` has the arguments; ``r2=None`` takes
    per-point radii from F_R).  On the card the callback is traced and
    compiled on first use of its expression."""
    cand_sets = P.check_active_args(desc, q_t, recs_t, n_win, tiles_cap,
                                    cand_sets, allow, r2, symmetric)
    _check_spec(spec)
    if desc.device.type == "cpu":
        return pairs_reduce_plain(desc, q_t, recs_t, n_win, tiles_cap, spec,
                                  cand_sets, allow, r2, symmetric)
    lib = reduce_library(spec, r2 is None).lib
    if desc.device.type != "cuda":
        raise ValueError(f"kernels take cpu or cuda tensors, got "
                         f"{desc.device}")
    out = torch.empty((spec.n_out, tiles_cap * P.TILE), dtype=torch.float32,
                      device=desc.device)
    stream = torch.cuda.current_stream(desc.device).cuda_stream
    err = lib.tns_pairs_reduce(
        desc.data_ptr(), q_t.data_ptr(), recs_t.data_ptr(), recs_t.shape[1],
        tiles_cap, n_win, float(r2 if r2 is not None else 0.0),
        int(symmetric), len(cand_sets), P.set_ids_arg(cand_sets),
        allow.data_ptr(), allow.shape[0], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pairs_reduce launch failed: CUDA error {err}")
    pairs_reduce.launches += 1
    return out


pairs_reduce.launches = 0
