"""Semiring-law verifier and the cross-check of the CUDA semiring table.

The whole engine rests on each registered ``Semiring`` being a semiring:
the SlimChunk split (partial rows of a chunk's pieces folded by the
semiring add), SlimWork's skipped-tile zeros, the ranks' all-reduce and
the loop's iteration order are only correct if add is an associative,
commutative monoid with identity ``zero``, mul distributes over it, and
``zero`` annihilates (padding slots must be no-ops). None of this is
visible to the type system, so this module checks it exhaustively on
small value domains:

* **laws** of each semiring of ``core.semiring``: add associativity,
  commutativity and identity, mul associativity and identity (both
  sides), annihilation by zero (both sides), distributivity (both sides),
  and the agreement of the reduction surfaces the sweeps use
  (``Semiring.reduce``, ``scatter_reduce`` or ``packing.segment_or``) with
  a fold of add. A ``Semiring`` names its add by its ``reduction`` kind
  (``ADD``); ``verify_semiring(add=)`` checks another;
* **packed words**: ``core.packing``'s OR reductions, pack / unpack and
  the tail-word invariant on multi-bit words (``verify_packed_words``);
* **the kernel table**, in two halves. On the CPU,
  ``cross_check_kernel_tables`` reads ``kernels/csrc/semiring.cuh``: its
  ``SemiringCode`` enum must name each registered semiring's ``code``;
  each struct's ``zero()``, ``edge(x)``, ``add(a, b)`` (and ``mul(w, x)``
  of min-plus), evaluated from the source, must agree with the port's
  table on the whole domain and obey the laws; ``dispatch_semiring`` must
  have a case for every implicit-sweep semiring and none for ``minplus``
  or ``boolean_packed``. On the card, ``cross_check_probe`` launches the
  entry ``semiring_probe`` (``csrc/semiring_probe.cu``), which evaluates
  the structs the kernels compile, and holds its tables to the port's,
  exactly, and to the laws (associativity through a second probe over
  the first one's sums); an unknown code must be refused.

CLI::

    python -m repro_torch.analysis.laws               # the CPU half
    python -m repro_torch.analysis.laws --device cuda # and the probe

Exit status 0 iff every registered semiring passes every check.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import options, packing
from ..core import semiring as sm

#: the binary add of each reduction kind
ADD: Dict[str, Callable] = {"min": torch.minimum, "max": torch.maximum,
                            "sum": torch.add, "or": torch.bitwise_or}

CUH = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc" \
    / "semiring.cuh"


def value_domain(sr) -> torch.Tensor:
    """A small closed-enough value domain: both identities plus a few
    ordinary payloads (valid for every registered semiring: sel-max
    payloads are 1-based ids, hence positive), ``zero`` first.

    The packed word semiring gets a *multi-bit* domain: single-bit words
    would let a max / OR confusion slip through (they agree on {0, 1}), so
    the payloads mix disjoint and overlapping bit patterns across both
    halves of the word. Words are int32 here, so 0xA5A50F0F and
    0x80000002 are negative."""
    if sr.reduction == "or":
        raw = (sr.zero, sr.one, 1, 2, 0xA5A50F0F, 0x80000002)
        vals = [int(np.int64(v).astype(np.uint32).view(np.int32))
                for v in raw]
    else:
        vals = [sr.zero, sr.one, 1, 2, 5]
    out = []
    for v in vals:
        if v not in out:
            out.append(v)
    return torch.tensor(out, dtype=sr.dtype)


def same(a, b) -> torch.Tensor:
    """Elementwise equality with NaN equal to NaN."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    same = a == b
    if a.is_floating_point():
        same |= torch.isnan(a) & torch.isnan(b)
    return same


def _where(ok: torch.Tensor, *axes: torch.Tensor) -> str:
    """The first failing point of a law as ``a=.., b=..``."""
    idx = torch.nonzero(~ok)[0].tolist()
    names = "abc"
    return ", ".join(f"{names[k]}={axes[k][i].item()!r}"
                     for k, i in enumerate(idx))


def verify_laws(name: str, dom: torch.Tensor, zero, add: Callable,
                mul: Optional[Callable] = None, one=None) -> List[str]:
    """The semiring laws on ``dom`` for the given operations: the add
    monoid always, the mul laws where ``mul`` is given (its identity where
    ``one`` is). Returns the violations."""
    errs: List[str] = []
    z = torch.tensor(zero, dtype=dom.dtype)
    a, b, c = dom[:, None, None], dom[None, :, None], dom[None, None, :]
    a2, b2 = dom[:, None], dom[None, :]

    def law(ok, what, *axes):
        if not bool(ok.all()):
            errs.append(f"{name}: {what} fails at ({_where(ok, *axes)})")

    law(same(add(dom, z), dom) & same(add(z, dom), dom), "add identity", dom)
    law(same(add(a2, b2), add(b2, a2)), "add commutativity", dom, dom)
    law(same(add(add(a, b), c), add(a, add(b, c))), "add associativity",
        dom, dom, dom)
    if mul is None:
        return errs
    if one is not None:
        o = torch.tensor(one, dtype=dom.dtype)
        law(same(mul(dom, o), dom), "right mul identity", dom)
        law(same(mul(o, dom), dom), "left mul identity", dom)
    law(same(mul(dom, z), z), "right annihilation", dom)
    law(same(mul(z, dom), z), "left annihilation", dom)
    law(same(mul(mul(a, b), c), mul(a, mul(b, c))), "mul associativity",
        dom, dom, dom)
    law(same(mul(a, add(b, c)), add(mul(a, b), mul(a, c))),
        "left distributivity", dom, dom, dom)
    law(same(mul(add(a, b), c), add(mul(a, c), mul(b, c))),
        "right distributivity", dom, dom, dom)
    return errs


def verify_semiring(sr, domain: Optional[torch.Tensor] = None, *,
                    add: Optional[Callable] = None) -> List[str]:
    """Exhaustively check the semiring laws on ``domain``; returns the
    violations (empty: ``sr`` is a semiring on that domain). ``add`` is
    the add of ``sr``'s reduction kind unless given."""
    dom = value_domain(sr) if domain is None \
        else torch.as_tensor(domain, dtype=sr.dtype)
    kind = getattr(sr, "reduction", None)
    if add is None:
        if kind not in ADD:
            return [f"{sr.name}: unknown reduction kind {kind!r}"]
        add = ADD[kind]
    errs = verify_laws(sr.name, dom, sr.zero, add, sr.mul, sr.one)
    if kind not in ADD:
        return errs + [f"{sr.name}: unknown reduction kind {kind!r}"]
    # the reduction surfaces the sweeps use must agree with a fold of add
    x = torch.stack([dom, dom.flip(0)])                 # [2, |dom|]
    fold = x[:, 0]
    for j in range(1, x.shape[1]):
        fold = add(fold, x[:, j])
    if not bool(same(sr.reduce(x, 1), fold).all()) \
            or not bool(same(sr.reduce(x.T, 0), fold).all()):
        errs.append(f"{sr.name}: Semiring.reduce disagrees with an add-fold")
    ids = torch.arange(2).repeat_interleave(dom.numel())
    if kind == "or":
        seg = packing.segment_or(x.reshape(-1), ids, 2)
    else:
        seg = torch.zeros(2, dtype=dom.dtype).scatter_reduce(
            0, ids, x.reshape(-1), sr.scatter_reduce, include_self=False)
    if not bool(same(seg, fold).all()):
        errs.append(f"{sr.name}: the segment reduction (scatter_reduce / "
                    "packing.segment_or) disagrees with an add-fold")
    return errs


def verify_all() -> Dict[str, List[str]]:
    """The law check of every registered semiring."""
    return {name: verify_semiring(sr) for name, sr in sm.SEMIRINGS.items()}


def verify_packed_words() -> List[str]:
    """SlimSell-B word-domain checks beyond the generic semiring laws.

    The packed path rides on ``core.packing``'s word-wise primitives, and
    each has a failure mode the scalar law check cannot see: a max-scatter
    of whole words in place of ``segment_or`` (the same on 0/1 lanes,
    wrong on multi-bit words), the halving fold of ``or_reduce``, and pack
    / unpack, which must keep every tail padding bit zero (one stray bit
    survives every OR downstream). All on multi-bit int32 words and ragged
    tail widths."""
    errs: List[str] = []
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 32, size=24, dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    words[3], words[11] = 0, packing.FULL_WORD   # identities in the stream
    seg_ids = np.sort(rng.integers(0, 5, size=24))
    seg_ids[seg_ids == 2] = 1                    # make one segment empty
    ref = np.zeros(5, np.int32)                  # empty segments: OR's 0
    for w, s in zip(words, seg_ids):
        ref[s] |= w
    got = packing.segment_or(torch.from_numpy(words),
                             torch.from_numpy(seg_ids), 5)
    if not bool(same(got, torch.from_numpy(ref)).all()):
        errs.append("packing.segment_or disagrees with a per-segment OR "
                    "fold on multi-bit words")
    mat = torch.from_numpy(words.reshape(4, 6))
    fold = torch.from_numpy(np.bitwise_or.reduce(words.reshape(4, 6), axis=1))
    if not bool(same(packing.or_reduce_last(mat), fold).all()):
        errs.append("packing.or_reduce_last disagrees with an OR fold")
    if not bool(same(packing.or_reduce(mat, (1,)), fold).all()):
        errs.append("packing.or_reduce disagrees with an OR fold")
    for n_bits in (1, 31, 32, 33, 64, 70):
        bits = torch.from_numpy(rng.integers(0, 2, size=n_bits).astype(bool))
        packed = packing.pack_bits(bits)
        if not bool(same(packing.unpack_bits(packed, n_bits), bits).all()):
            errs.append(f"pack/unpack roundtrip fails at n_bits={n_bits}")
        pad = torch.from_numpy(packing.padding_mask(n_bits))
        if bool(((packed & ~pad) != 0).any()) \
                or not packing.check_tail_zero_host(packed.numpy(), n_bits):
            errs.append(f"pack_bits leaves nonzero tail padding at "
                        f"n_bits={n_bits}")
        if not np.array_equal(packing.pack_bits_np(bits.numpy()),
                              packed.numpy()):
            errs.append(f"pack_bits_np disagrees with pack_bits at "
                        f"n_bits={n_bits}")
    return errs


# ------------------------------------------------------ the CUDA table, CPU


_C_TYPES = {"float": torch.float32, "int": torch.int32}
_C_FUNCS = {"fminf": torch.minimum, "fmaxf": torch.maximum,
            "min": torch.minimum, "max": torch.maximum}
_C_BINOPS = {ast.Add: torch.add, ast.Sub: torch.sub, ast.Mult: torch.mul,
             ast.BitOr: torch.bitwise_or, ast.BitAnd: torch.bitwise_and}


@dataclasses.dataclass
class KernelSemiring:
    """One ``Semiring<CODE>`` struct of ``semiring.cuh``, its methods
    evaluated from their source on PyTorch tensors (None: not defined)."""
    name: str
    dtype: torch.dtype
    zero: float
    add: Callable
    edge: Optional[Callable] = None
    mul: Optional[Callable] = None


@dataclasses.dataclass
class KernelTable:
    enum: Dict[str, int]            # SemiringCode: NAME -> code
    structs: Dict[str, KernelSemiring]
    dispatch: List[str]             # the cases of dispatch_semiring


def _c_function(expr: str, params: Sequence[str], dtype: torch.dtype,
                where: str) -> Callable:
    """A C return expression over ``params`` (``fminf``, ``fmaxf``,
    ``max``, ``min``, + - * | &, float literals, ``CUDART_INF_F``) as a
    function of tensors; anything else is refused."""
    py = re.sub(r"\b(\d+\.\d*|\.\d+|\d+)[fF]\b", r"\1", expr)
    py = py.replace("CUDART_INF_F", "INF")
    try:
        tree = ast.parse(py.strip(), mode="eval").body
    except SyntaxError as e:
        raise ValueError(f"{where}: cannot read {expr!r}") from e

    def ev(node, env):
        if isinstance(node, ast.Constant) and isinstance(node.value,
                                                         (int, float)):
            return torch.tensor(node.value, dtype=dtype)
        if isinstance(node, ast.Name):
            if node.id == "INF":
                return torch.tensor(float("inf"), dtype=dtype)
            if node.id in env:
                return env[node.id]
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -ev(node.operand, env)
        if isinstance(node, ast.BinOp) and type(node.op) in _C_BINOPS:
            return _C_BINOPS[type(node.op)](ev(node.left, env),
                                            ev(node.right, env)).to(dtype)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in _C_FUNCS and len(node.args) == 2:
            return _C_FUNCS[node.func.id](*(ev(a, env) for a in node.args))
        raise ValueError(f"{where}: cannot evaluate {ast.unparse(node)!r} "
                         f"in {expr!r}")

    def fn(*args):
        out = ev(tree, dict(zip(params, args)))
        if args:
            out = out.expand(torch.broadcast_shapes(*(a.shape for a in args)))
        return out
    return fn


def parse_kernel_table(text: str) -> KernelTable:
    """The enum, the structs and the dispatch cases of ``semiring.cuh``."""
    m = re.search(r"enum\s+SemiringCode\s*\{(.*?)\}", text, re.S)
    if m is None:
        raise ValueError("semiring.cuh: no enum SemiringCode")
    enum = {k: int(v) for k, v in re.findall(r"(\w+)\s*=\s*(-?\d+)",
                                             m.group(1))}
    structs = {}
    for name, body in re.findall(
            r"template\s*<>\s*struct\s+Semiring<(\w+)>\s*\{(.*?)\n\};",
            text, re.S):
        t = re.search(r"using\s+T\s*=\s*(\w+)\s*;", body)
        dtype = _C_TYPES.get(t.group(1)) if t else None
        if dtype is None:
            raise ValueError(f"Semiring<{name}>: no known value type T")
        methods = {}
        for meth, params, expr in re.findall(
                r"static\s+T\s+(\w+)\s*\(([^)]*)\)\s*\{\s*return\s+(.*?);\s*\}",
                body, re.S):
            names = [p.split()[-1] for p in params.split(",") if p.strip()]
            methods[meth] = _c_function(expr, names, dtype,
                                        f"Semiring<{name}>::{meth}")
        if "zero" not in methods or "add" not in methods:
            raise ValueError(f"Semiring<{name}>: needs zero() and add()")
        structs[name] = KernelSemiring(
            name=name, dtype=dtype, zero=methods["zero"]().item(),
            add=methods["add"], edge=methods.get("edge"),
            mul=methods.get("mul"))
    d = re.search(r"dispatch_semiring\s*\(.*?\{(.*?)\n\}", text, re.S)
    dispatch = re.findall(r"case\s+(\w+)\s*:", d.group(1)) if d else []
    return KernelTable(enum=enum, structs=structs, dispatch=dispatch)


def _implicit(sr) -> bool:
    """Swept by the implicit-edge-value kernels through
    ``dispatch_semiring``: not min-plus (stored weights), not the packed
    words (kernels of their own)."""
    return sr.reduction != "or" and sr.name != "minplus"


def cross_check_kernel_tables(source: Optional[str] = None) -> List[str]:
    """The CPU half: prove the CUDA table in ``semiring.cuh`` (or the given
    ``source`` text of it) agrees with ``core.semiring`` for every
    registered name, dispatch exhaustiveness included (an unhandled name
    is reported, not skipped)."""
    text = CUH.read_text() if source is None else source
    errs: List[str] = []
    if tuple(sm.SEMIRINGS) != options.SEMIRINGS:
        errs.append(f"core.semiring registry {tuple(sm.SEMIRINGS)} != "
                    f"options.SEMIRINGS {options.SEMIRINGS}")
    try:
        table = parse_kernel_table(text)
    except ValueError as e:
        return errs + [str(e)]
    for key, code in table.enum.items():
        if key.lower() not in sm.SEMIRINGS:
            errs.append(f"kernel enum SemiringCode names {key} = {code}, "
                        "which is no registered semiring")
    for name in options.SEMIRINGS:
        sr = sm.SEMIRINGS[name]
        key = name.upper()
        if table.enum.get(key) != sr.code:
            errs.append(f"{name}: kernel enum SemiringCode gives "
                        f"{table.enum.get(key)}, core code is {sr.code}")
        in_dispatch = key in table.dispatch
        if _implicit(sr) and not in_dispatch:
            errs.append(f"kernel dispatch_semiring has no dispatch for "
                        f"registered semiring {name!r}")
        if not _implicit(sr) and in_dispatch:
            errs.append(f"kernel dispatch_semiring dispatches {name!r}, "
                        "which no implicit sweep takes")
        if sr.reduction == "or":
            continue
        ks = table.structs.get(key)
        if ks is None:
            errs.append(f"{name}: no Semiring<{key}> struct in the kernel "
                        "table")
            continue
        errs += _compare_table(sr, ks)
        errs += verify_laws(f"kernel {name}", value_domain(sr), ks.zero,
                            ks.add, ks.mul)
    return errs


def _compare_table(sr, ks: KernelSemiring) -> List[str]:
    """A parsed struct against the port's semiring on its domain."""
    if ks.dtype != sr.dtype:
        return [f"{sr.name}: kernel value type {ks.dtype} != core "
                f"{sr.dtype}"]
    errs = []
    x = value_domain(sr)
    a, b = x[:, None], x[None, :]
    if not bool(same(torch.tensor(ks.zero, dtype=sr.dtype),
                    torch.tensor(sr.zero, dtype=sr.dtype))):
        errs.append(f"{sr.name}: kernel zero {ks.zero!r} != core zero "
                    f"{sr.zero!r}")
    if not bool(same(ks.add(a, b), ADD[sr.reduction](a, b)).all()):
        errs.append(f"{sr.name}: kernel add != core add")
    if sr.name == "minplus":
        if ks.mul is None or not bool(same(ks.mul(a, b), sr.mul(a, b)).all()):
            errs.append(f"{sr.name}: kernel mul(w, x) != sr.mul(w, x)")
    elif ks.edge is None or not bool(same(ks.edge(x), sr.edge(x)).all()):
        errs.append(f"{sr.name}: kernel edge contribution != "
                    "sr.mul(edge_value, x)")
    return errs


# ----------------------------------------------------- the CUDA table, card


def probe(code: int, values: torch.Tensor) -> dict:
    """One launch of ``semiring_probe`` on ``values`` (a CUDA tensor of the
    semiring's type, at most 32): ``{"zero": [1], "edge": [n], "add": [n,
    n], "mul": [n, n]}`` (``edge`` unwritten for min-plus, ``mul`` for the
    others). Raises, without a launch, on an unknown code."""
    from ..kernels import ops
    x = values.contiguous()
    n = x.numel()
    out = {"zero": x.new_empty(1), "edge": x.new_empty(n),
           "add": x.new_empty((n, n)), "mul": x.new_empty((n, n))}
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ops.SEMIRING_PROBE.launch(int(code), x.data_ptr(), n,
                                  out["zero"].data_ptr(),
                                  out["edge"].data_ptr(),
                                  out["add"].data_ptr(),
                                  out["mul"].data_ptr(), stream)
    return out


def table_on(sr, x: torch.Tensor) -> dict:
    """The port's table on the probe's values, on their device."""
    a, b = x[:, None], x[None, :]
    want = {"zero": torch.full((1,), sr.zero, dtype=sr.dtype,
                               device=x.device),
            "add": ADD[sr.reduction](a, b)}
    if sr.name == "minplus":
        want["mul"] = sr.mul(a, b)
    else:
        want["edge"] = sr.edge(x)
    return want


def cross_check_probe(device, *, unknown_code: int = 6) -> List[str]:
    """The card half: the probe's tables against the port's, exactly, for
    every semiring with a struct in the kernel table, and the laws on the
    probe's own tables: identity, commutativity and the annihilation of
    its first launch, associativity and distributivity through a second
    launch over the first one's sums (and products). An unknown code must
    be refused."""
    errs: List[str] = []
    for name in options.SEMIRINGS:
        sr = sm.SEMIRINGS[name]
        if sr.reduction == "or":
            continue
        x = value_domain(sr).to(device)
        got = probe(sr.code, x)
        for k, v in table_on(sr, x).items():
            if not bool(same(got[k], v).all()):
                errs.append(f"{name}: the probe's {k} on the card != the "
                            f"port's table: {got[k].cpu().tolist()} vs "
                            f"{v.cpu().tolist()}")
        errs += _probe_laws(sr, x, got)
    try:
        probe(unknown_code, torch.zeros(2, device=device))
        errs.append(f"the probe took unknown code {unknown_code}")
    except RuntimeError as e:
        if "CUDA error 1 " not in str(e):     # cudaErrorInvalidValue
            errs.append(f"the probe refused code {unknown_code} with "
                        f"another error: {e}")
    return errs


def _probe_laws(sr, x: torch.Tensor, got: dict) -> List[str]:
    """The laws on the probe's tables (x[0] is zero)."""
    errs = []
    n = x.numel()
    add1 = got["add"]
    if not bool((same(add1[0], x) & same(add1[:, 0], x)).all()):
        errs.append(f"{sr.name}: probe add identity fails")
    if not bool(same(add1, add1.T).all()):
        errs.append(f"{sr.name}: probe add commutativity fails")
    # a second launch over x and the first launch's sums v[i, j]:
    # add(v[i, j], x[k]) == add(x[i], v[j, k])
    w = torch.cat([x, add1.reshape(-1)])
    add2 = probe(sr.code, w)["add"]
    i, j, k = torch.meshgrid(*(torch.arange(n, device=x.device),) * 3,
                             indexing="ij")
    left = add2[n + i * n + j, k]
    right = add2[i, n + j * n + k]
    if not bool(same(left, right).all()):
        errs.append(f"{sr.name}: probe add associativity fails")
    if sr.name != "minplus":
        return errs
    mul1 = got["mul"]
    zero = got["zero"][0]
    if not bool((same(mul1[:, 0], zero) & same(mul1[0], zero)).all()):
        errs.append(f"{sr.name}: probe annihilation fails")
    # mul(x[a], v[b, c]) from the second launch against add(m[a, b],
    # m[a, c]) from a third over x and the products m
    mul2 = probe(sr.code, w)["mul"]
    add3 = probe(sr.code, torch.cat([x, mul1.reshape(-1)]))["add"]
    lhs = mul2[i, n + j * n + k]
    rhs = add3[n + i * n + j, n + i * n + k]
    if not bool(same(lhs, rhs).all()):
        errs.append(f"{sr.name}: probe left distributivity fails")
    return errs


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="a CUDA device: also run the probe on the card")
    args = ap.parse_args(argv)
    failures: List[str] = []
    checks = [(f"laws: {name}", errs) for name, errs in verify_all().items()]
    checks.append(("kernel-table cross-check (semiring.cuh)",
                   cross_check_kernel_tables()))
    checks.append(("packed word domain", verify_packed_words()))
    if args.device is not None:
        checks.append((f"semiring_probe on {args.device}",
                       cross_check_probe(torch.device(args.device))))
    for what, errs in checks:
        if not args.quiet:
            print(f"  [{'FAIL' if errs else 'ok'}] {what}")
        failures.extend(errs)
    if failures:
        print(f"\n{len(failures)} semiring violation(s):")
        for e in failures:
            print(f"  {e}")
        return 1
    print(f"semiring laws OK: {len(sm.SEMIRINGS)} semirings verified, "
          "kernel tables agree")
    return 0


if __name__ == "__main__":
    sys.exit(main())
