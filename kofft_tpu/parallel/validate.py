"""Machine-checked communication-volume invariants.

The sharded programs must move exactly the canonical collective volume:
each tiled ``all_to_all`` relocates ``(D-1)/D`` of the local shard,
constant per device in weak scaling. The volume is checkable on any
backend by auditing the compiled HLO — which is what these helpers do
(report the invariant as a checked property, not a docstring remark).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = ["hlo_all_to_all_local_bytes", "fft_sharded_expected_a2a_bytes",
           "check_fft_sharded_comm_volume", "hlo_a2a_independent_sources",
           "hlo_a2a_bytes_by_group_size", "hlo_ppermute_bytes_by_tier"]

_DTYPE_BYTES = {"f32": 4, "f64": 8, "bf16": 2, "f16": 2, "c64": 8,
                "c128": 16, "s32": 4, "u32": 4}

_SHAPE = re.compile(r"(f32|f64|bf16|f16|c64|c128|s32|u32)\[([\d,]*)\]")
_DEF = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_OPCODE = re.compile(r"\s([a-z][a-z0-9\-]*)\(")
_HEADER = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)")
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_REF = re.compile(r"%([\w.\-]+)")
_GROUPS = re.compile(r"replica_groups=\{(\{[\d,]+\})")


@dataclass(frozen=True)
class _Op:
    name: str
    comp: str
    opcode: str
    type_text: str
    rest: str          # operand list and attributes

    @property
    def operands(self) -> list:
        return [r for r in _REF.findall(self.rest) if r != self.name]

    @property
    def calls(self):
        m = _CALLS.search(self.rest)
        return m.group(1) if m else None


def _hlo_ops(compiled_text: str) -> list:
    """The instructions of an HLO module text, each with the computation
    it sits in. The opcode is read from the instruction itself, not its
    name: backends name collectives differently (a GPU module may wrap an
    all-to-all in an async computation under another name)."""
    ops, comp = [], ""
    for line in compiled_text.splitlines():
        stripped = line.strip()
        if stripped.endswith("{") and " = " not in stripped:
            m = _HEADER.match(stripped)
            comp = m.group(1) if m else ""
            continue
        m = _DEF.match(line)
        if not m:
            continue
        rest = " " + m.group(2)
        op = _OPCODE.search(rest)
        if not op:
            continue
        ops.append(_Op(m.group(1), comp, op.group(1), rest[: op.start()],
                       rest[op.end():]))
    return ops


def _float_shape_bytes(type_text: str) -> int:
    """Sum the byte sizes of the float shapes in an HLO type string
    (s32/u32 async-control scalars skipped)."""
    total = 0
    for dt, dims in _SHAPE.findall(type_text):
        if dt in ("s32", "u32"):
            continue
        elems = 1
        for d in dims.split(","):
            if d:
                elems *= int(d)
        total += elems * _DTYPE_BYTES[dt]
    return total


def _a2a_transfers(ops: list) -> list:
    """(op, attribute-bearing op) for every all-to-all transfer, counted
    once: a synchronous ``all-to-all`` by its result (one inside an async
    wrapper computation once per ``async-start`` that calls it), an
    ``all-to-all-start``/``-done`` pair by the DONE op's result type —
    the transferred shard, whatever aliased buffers the start tuple
    lists."""
    by_name = {op.name: op for op in ops}
    wrapped = {op.calls for op in ops if op.opcode == "async-start"}
    out = []
    for op in ops:
        if op.opcode == "all-to-all" and op.comp not in wrapped:
            out.append((op, op))
        elif op.opcode == "all-to-all-done":
            start = by_name.get(op.operands[0]) if op.operands else None
            out.append((op, start or op))
        elif op.opcode == "async-start":
            out += [(inner, inner) for inner in ops
                    if inner.comp == op.calls
                    and inner.opcode == "all-to-all"]
    return out


def hlo_all_to_all_local_bytes(compiled_text: str) -> int:
    """Total local bytes participating in ``all-to-all`` ops in a
    compiled (post-SPMD) HLO module, per device.

    Handles the forms XLA emits: a single tiled array result, the
    tuple-of-chunks decomposition (one operand per peer) — where the
    result shapes sum to the full local shard — async start/done pairs,
    and async wrapper computations around a synchronous op."""
    return sum(_float_shape_bytes(op.type_text)
               for op, _ in _a2a_transfers(_hlo_ops(compiled_text)))


def hlo_a2a_bytes_by_group_size(compiled_text: str) -> dict:
    """Per-axis collective volume audit for two-level (slice, chip)
    programs: local all-to-all bytes keyed by the op's replica-group
    size. On a two-level mesh the intra-group legs have groups of
    ``chips_per_slice`` and the inter-group legs groups of ``n_slices``
    — so the returned dict states exactly how many bytes ride each leg
    (SURVEY §5.8's split as a checked property)."""
    out: dict[int, int] = {}
    for op, attrs in _a2a_transfers(_hlo_ops(compiled_text)):
        g = _GROUPS.search(attrs.rest)
        size = len(g.group(1).strip("{}").split(",")) if g else 0
        out[size] = out.get(size, 0) + _float_shape_bytes(op.type_text)
    return out


_CPERM = re.compile(
    r"=\s*(.*?)\s*collective-permute(?:-start)?\(", re.DOTALL)
_PAIRS = re.compile(r"source_target_pairs=\{((?:\{\d+,\d+\},?)+)\}")
_PAIR = re.compile(r"\{(\d+),(\d+)\}")


def hlo_ppermute_bytes_by_tier(compiled_text: str,
                               chips_per_slice: int) -> dict:
    """Per-tier volume audit for hierarchical halo exchange: bytes moved
    by ``collective-permute`` ops, split by whether each (src, dst) pair
    stays within a slice (``ici``) or crosses slices (``dcn``) under the
    row-major (slice-major, chip-minor) device linearization. Each pair
    moves the op's per-shard payload once, so
    ``bytes = payload_bytes * n_pairs`` per tier — the checked form of
    SURVEY §5.8's "halo bytes cross a slice boundary exactly once".
    Async start/done pairs are counted once (at the start op, whose
    attribute line carries the pairs)."""
    out = {"ici": 0, "dcn": 0}
    for line in compiled_text.splitlines():
        m = _CPERM.search(line)
        if not m or "collective-permute-done" in line:
            continue
        pairs = _PAIRS.search(line)
        if not pairs:
            continue
        payload = _float_shape_bytes(line[: m.end()])
        if "-start" in line:
            # start result is a (operand, result, ...) tuple: the
            # transferred shard is counted once, not per tuple element
            payload = _float_shape_bytes(m.group(1)) // 2 or payload
        for a, b in _PAIR.findall(pairs.group(1)):
            tier = ("ici" if int(a) // chips_per_slice
                    == int(b) // chips_per_slice else "dcn")
            out[tier] += payload
    return out


def hlo_a2a_independent_sources(compiled_text: str) -> dict:
    """Dependency-structure audit of the collective pipeline.

    Parses the compiled HLO's op graph (op -> operand names) and
    classifies every all-to-all (sync form, async START, or an async
    wrapper around one; -done ops are the completion of a start and not
    counted separately): an op is an *independent source* when no other
    all-to-all is among its transitive operands. The sequential
    four-step has exactly 2 (the stage-1 re/im pair — everything later
    depends on them); the ``overlap=K`` pipeline has 2K mutually
    independent stage-A chains, which is precisely the property that
    lets XLA's latency-hiding scheduler fly chunk k+1's collective
    during chunk k's DFT. Returns
    ``{"total": ..., "independent_sources": ...}``."""
    ops = _hlo_ops(compiled_text)
    wrapped = {op.calls for op in ops if op.opcode == "async-start"}
    a2a_comps = {op.comp for op in ops if op.opcode == "all-to-all"}

    def is_a2a(op) -> bool:
        if op.opcode in ("all-to-all", "all-to-all-start"):
            return op.comp not in wrapped
        return op.opcode == "async-start" and op.calls in a2a_comps

    by_name = {op.name: op for op in ops}
    memo: dict[str, bool] = {}

    def has_a2a_ancestor(name: str) -> bool:
        if name in memo:
            return memo[name]
        memo[name] = False           # cycle guard (HLO is a DAG)
        out = False
        for dep in by_name[name].operands if name in by_name else ():
            if dep in by_name and (is_a2a(by_name[dep])
                                   or has_a2a_ancestor(dep)):
                out = True
                break
        memo[name] = out
        return out

    a2as = [op.name for op in ops if is_a2a(op)]
    indep = [nm for nm in a2as if not has_a2a_ancestor(nm)]
    return {"total": len(a2as), "independent_sources": len(indep)}


def fft_sharded_expected_a2a_bytes(n: int, d: int,
                                   restore_layout: bool) -> int:
    """Canonical local volume for the distributed four-step 1-D FFT
    (``fft_sharded``): 2 all_to_alls (3 with layout restore), each over
    both (re, im) f32 planes of the local n/d-point shard."""
    steps = 3 if restore_layout else 2
    return steps * 2 * (n // d) * 4


def check_fft_sharded_comm_volume(n: int, mesh, axis_name: str = "d",
                                  restore_layout: bool = True,
                                  backend: str = "xla",
                                  overlap: int = 1) -> dict:
    """Compile the sharded FFT for (n, mesh) and verify the HLO moves
    exactly the canonical all_to_all volume. Returns a report dict;
    raises AssertionError on mismatch (more collective traffic than the
    algorithm specifies = an XLA regression or a program bug).

    The *cross-chip* fraction of the audited local volume is (D-1)/D by
    the all_to_all contract; auditing local participation pins the same
    invariant without modeling the interconnect. The ``overlap=K``
    pipeline must move the SAME canonical bytes (only the granularity
    changes: 2K + K chunk collectives instead of 2 + 1); the report
    additionally carries the dependency audit
    (:func:`hlo_a2a_independent_sources`)."""
    import jax
    import numpy as np

    from ..config import trace_key
    from .fft_sharded import _build, _mesh_key, _split_for_mesh

    d = mesh.shape[axis_name]
    split = _split_for_mesh(n, d)
    assert split is not None, f"n={n} does not factorize for d={d}"
    # explicit dtype so this shares the lru entry (and therefore the
    # compiled executable) with the production fft_sharded call
    fn, sharding = _build(_mesh_key(mesh, axis_name), n, split[0], split[1],
                          backend, restore_layout, trace_key(), overlap,
                          "float32")
    x = jax.device_put(np.zeros(n, np.float32), sharding)
    txt = fn.lower(x, x).compile().as_text()
    got = hlo_all_to_all_local_bytes(txt)
    want = fft_sharded_expected_a2a_bytes(n, d, restore_layout)
    assert got == want, (
        f"all_to_all local volume {got} B != canonical {want} B "
        f"(n={n}, d={d}, restore={restore_layout}, overlap={overlap})")
    dep = hlo_a2a_independent_sources(txt)
    return {"n": n, "d": d, "restore_layout": restore_layout,
            "overlap": overlap, "local_a2a_bytes": got,
            "cross_chip_bytes": got * (d - 1) // d, **dep}
