"""Bucket accumulation as a segmented scan over sorted entries.

Entries sorted by bucket are cut into fragments of K = 64; each fragment is
scanned on its own (one mixed add per entry), and a hierarchical carry scan
over fragments (`seg_carry_scan`) stitches buckets that span fragments.

The scan variants are the JAX package's, one recurrence with three choices
(`_scan_plain`, and the template of csrc/scan.cuh):

    wrapper               rows                mask            stored steps
    msm_scan_fused        table by index      key compare     all (the main path)
    msm_scan_table_signed table by index,     bits + sign     all (fixed base)
                          single
    msm_scan_rm_sames     row-major           hoisted bits    all
    msm_scan_rm_signed    row-major, single   bits + sign     all
    msm_scan              row-major           key compare     all
    msm_scan_pret         limb-major          key compare     all
    msm_scan_sames        limb-major          hoisted bits    all
    msm_scan_signed       limb-major, single  bits + sign     all
    msm_scan_rm_sames_q   row-major           hoisted bits    4i+2, 4i+3
    msm_scan_table_sames  table by index      hoisted bits    all

"Table by index" reads each entry's row from the table inside the scan, with
no gathered copy: the JAX package's row gather (ops/pallas/gather.py::
dma_row_gather) folded into the scan that reads its output.

Kernels: csrc/scan.cu (the first four and the carry scan) and
csrc/scan_variants.cu, replacing the JAX package's ops/pallas/scan.py::
_msm_scan_rm_sames_kernel, _msm_scan_rm_signed_kernel, _msm_scan_kernel,
_msm_scan_pret_kernel, _msm_scan_sames_kernel, _msm_scan_signed_kernel,
_msm_scan_rm_sames_q_kernel, _msm_scan_fused_kernel and _ab_scan_kernel.
"""

from __future__ import annotations

import torch

from . import _build
from .common import L, fr_neg_lazy, load_consts, u32
from .convert import TWR
from .ec import TW, full_add, madd, masked_add_rows, pt_identity, pt_select, pt_to_rows, rows_to_pt

#: Entries per fragment (scan depth).
K = 64
#: Fragments per block of the limb-major (pret) layout, halved until it
#: divides the fragment count.
LBLK = 256


def keys_to_sames(keys_t: torch.Tensor) -> torch.Tensor:
    """[K, NF] sorted bucket keys -> [K, NF] int32 same-as-previous bits.
    Row 0 is 0: every fragment starts a fresh segment, and continuation
    across fragments is the carry scan's job."""
    eq = (keys_t[1:] == keys_t[:-1]).to(torch.int32)
    return torch.cat([torch.zeros_like(eq[:1]), eq])


def _scan_plain(read_rows, aux_t: torch.Tensor, mask: str, store: int = 2,
                sgn_t: torch.Tensor | None = None, sel: bool = True, write: bool = True,
                perstep_read: bool = True, add=madd) -> torch.Tensor:
    """The scan recurrence of the JAX package's _msm_scan_body.
    read_rows(j) -> [3L, NF] int64 limb slab of step j's table rows; aux_t
    [K, NF] int32 step words, read by `mask`: "keys" compares sorted keys
    with the previous step's (-1 before step 0), "sames" takes the hoisted
    bit, "signed" bit 0 as the same bit and bit 1 as the digit's sign,
    "keys_sgn" compares keys and negates y-x and 2*d*t (4p - v, no swap) of
    an entry whose sgn_t [K, NF] word is not 0.  store=1 keeps every step in
    its own row ([NF, K, TW]), store=2 every step, two side by side per row,
    store=4 steps 4i+2 and 4i+3 ([NF, K//store, 2*TW]).  The ablations of
    experiments/scan_floor_probe.py: sel=False drops the segment select,
    write=False keeps only the last pair (the other rows are zero),
    perstep_read=False reads step 0's rows at every step.  `add` is the
    mixed add (ec.py::madd)."""
    nf = aux_t.shape[1]
    c = load_consts(aux_t.device)
    ident = pt_identity(nf, c)
    acc = ident
    kprev = torch.full((nf,), -1, dtype=aux_t.dtype, device=aux_t.device)
    slab0 = None if perstep_read else read_rows(0)
    steps = []
    for j in range(K):
        slab = read_rows(j) if perstep_read else slab0
        d2, s2, td2 = slab[0:L], slab[L:2 * L], slab[2 * L:3 * L]
        aux = aux_t[j]
        if mask in ("keys", "keys_sgn"):
            same, kprev = aux == kprev, aux
            if mask == "keys_sgn":
                neg = sgn_t[j] != 0
                d2 = torch.where(neg, fr_neg_lazy(d2, c), d2)
                td2 = torch.where(neg, fr_neg_lazy(td2, c), td2)
        elif mask == "sames":
            same = aux != 0
        else:
            neg = (aux & 2) != 0
            d2, s2 = torch.where(neg, s2, d2), torch.where(neg, d2, s2)
            td2 = torch.where(neg, fr_neg_lazy(td2, c), td2)
            same = (aux & 1) != 0
        acc = add(pt_select(same, acc, ident) if sel else acc, d2, s2, td2, c)
        if store <= 2 or j % 4 >= 2:
            steps.append(pt_to_rows(acc) if write or j >= K - 2 else None)
    if not write:
        steps = [torch.zeros_like(steps[-1]) if s is None else s for s in steps]
    return torch.stack(steps, dim=1).reshape(nf, -1, TW if store == 1 else 2 * TW)


def _rm_reader(rows: torch.Tensor):
    """Step reader of row-major [NF, K, TWR] rows."""
    return lambda j: u32(rows[:, j, 0:3 * L]).T


def _pret_reader(rows_t: torch.Tensor):
    """Step reader of limb-major [NF//lblk, K, 64, lblk] rows: fragment f is
    lane f % lblk of block f // lblk."""
    nfb, _, _, lblk = rows_t.shape
    return lambda j: u32(rows_t[:, j, 0:3 * L, :]).permute(1, 0, 2).reshape(3 * L, nfb * lblk)


def msm_scan_rm_sames_plain(rows: torch.Tensor, sames_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`msm_scan_rm_sames`."""
    return _scan_plain(_rm_reader(rows), sames_t, "sames")


def msm_scan_rm_signed_plain(rows: torch.Tensor, bits_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`msm_scan_rm_signed`."""
    return _scan_plain(_rm_reader(rows), bits_t, "signed")


def msm_scan_plain(rows: torch.Tensor, keys_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`msm_scan`."""
    return _scan_plain(_rm_reader(rows), keys_t, "keys")


def msm_scan_pret_plain(rows_t: torch.Tensor, keys_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`msm_scan_pret`."""
    return _scan_plain(_pret_reader(rows_t), keys_t, "keys")


def msm_scan_sames_plain(rows_t: torch.Tensor, sames_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`msm_scan_sames`."""
    return _scan_plain(_pret_reader(rows_t), sames_t, "sames")


def msm_scan_signed_plain(rows_t: torch.Tensor, bits_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`msm_scan_signed`."""
    return _scan_plain(_pret_reader(rows_t), bits_t, "signed")


def msm_scan_rm_sames_q_plain(rows: torch.Tensor, sames_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`msm_scan_rm_sames_q`."""
    return _scan_plain(_rm_reader(rows), sames_t, "sames", store=4)


def _table_reader(table: torch.Tensor, pidx_t: torch.Tensor):
    """Step reader of table rows by index: step j of fragment f reads row
    pidx_t[j, f]."""
    return lambda j: u32(table[pidx_t[j].to(torch.int64), 0:3 * L]).T


def msm_scan_fused_plain(table: torch.Tensor, pidx_t: torch.Tensor,
                         keys_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`msm_scan_fused`."""
    return _scan_plain(_table_reader(table, pidx_t), keys_t, "keys")


def msm_scan_table_sames_plain(table: torch.Tensor, pidx_t: torch.Tensor,
                               sames_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`msm_scan_table_sames`: the rows indexed, then
    the plain scan of :func:`msm_scan_rm_sames`."""
    return _scan_plain(_table_reader(table, pidx_t), sames_t, "sames")


def msm_scan_table_signed_plain(table: torch.Tensor, pidx_t: torch.Tensor,
                                bits_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`msm_scan_table_signed`: the rows indexed, then
    the plain scan of :func:`msm_scan_rm_signed`."""
    return _scan_plain(_table_reader(table, pidx_t), bits_t, "signed")


def _launch_rm(kernel: str, lib: str, fn: str, rows: torch.Tensor, aux_t: torch.Tensor,
               store: int = 2) -> torch.Tensor:
    nf = rows.shape[0]
    rows = _build.check(rows, torch.int32, (nf, K, TWR), "rows")
    aux_t = _build.check(aux_t, torch.int32, (K, nf), "aux_t")
    out = torch.empty((nf, K // store, 2 * TW), dtype=torch.int32, device=rows.device)
    _build.launch(kernel, lib, fn, rows, aux_t, out, nf)
    return out


def _launch_pret(kernel: str, fn: str, rows_t: torch.Tensor, aux_t: torch.Tensor) -> torch.Tensor:
    if rows_t.dim() != 4:
        raise ValueError(f"rows_t: expected [NF//lblk, K, 64, lblk], got {tuple(rows_t.shape)}")
    nfb, _, _, lblk = rows_t.shape
    nf = nfb * lblk
    rows_t = _build.check(rows_t, torch.int32, (nfb, K, 64, lblk), "rows_t")
    aux_t = _build.check(aux_t, torch.int32, (K, nf), "aux_t")
    out = torch.empty((nf, K // 2, 2 * TW), dtype=torch.int32, device=rows_t.device)
    _build.launch(kernel, "scan_variants", fn, rows_t, aux_t, out, nf, lblk)
    return out


def _launch_table(kernel: str, lib: str, fn: str, table: torch.Tensor, pidx_t: torch.Tensor,
                  aux_t: torch.Tensor) -> torch.Tensor:
    """Launch a scan that reads table rows by index.  pidx_t is passed where
    it lies, with its strides: the pipeline's is a transposed view."""
    nf = pidx_t.shape[-1]
    table = _build.check(table, torch.int32, (-1, TWR), "table")
    if pidx_t.dtype != torch.int32 or tuple(pidx_t.shape) != (K, nf):
        raise ValueError(f"pidx_t: expected int32 [{K}, NF], got {pidx_t.dtype} "
                         f"{tuple(pidx_t.shape)}")
    aux_t = _build.check(aux_t, torch.int32, (K, nf), "aux_t")
    out = torch.empty((nf, K // 2, 2 * TW), dtype=torch.int32, device=table.device)
    _build.launch(kernel, lib, fn, table, pidx_t, *pidx_t.stride(), aux_t, out, nf)
    return out


def msm_scan_table_sames(table: torch.Tensor, pidx_t: torch.Tensor,
                         sames_t: torch.Tensor) -> torch.Tensor:
    """As :func:`msm_scan_rm_sames`, reading step j of fragment f from row
    pidx_t[j, f] of the doubled table (table [ns, TWR] int32; pidx_t [K, NF]
    int32 rows in [0, ns), of any strides: the kernel reads the indices
    where they lie): the row gather folded into the scan, so no gathered
    copy of the rows is made.  Launches csrc/scan_variants.cu on CUDA
    tensors; CPU tensors take the plain version."""
    _build.capture("scan_table", table, pidx_t, sames_t)
    if not _build.on_cuda(table, pidx_t, sames_t):
        return msm_scan_table_sames_plain(table, pidx_t, sames_t)
    return _launch_table("scan_table", "scan_variants", "msm_scan_table_sames", table, pidx_t,
                         sames_t)


def msm_scan_table_signed(table: torch.Tensor, pidx_t: torch.Tensor,
                          bits_t: torch.Tensor) -> torch.Tensor:
    """As :func:`msm_scan_rm_signed`, reading rows of the single table by
    index as :func:`msm_scan_table_sames` does.  Launches csrc/scan.cu on
    CUDA tensors; CPU tensors take the plain version."""
    _build.capture("scan_table_signed", table, pidx_t, bits_t)
    if not _build.on_cuda(table, pidx_t, bits_t):
        return msm_scan_table_signed_plain(table, pidx_t, bits_t)
    return _launch_table("scan_table_signed", "scan", "msm_scan_table_signed", table, pidx_t,
                         bits_t)


def msm_scan_rm_sames(rows: torch.Tensor, sames_t: torch.Tensor) -> torch.Tensor:
    """rows: [NF, K, TWR] int32 gathered table rows (pre-negated, row-major);
    sames_t: [K, NF] int32 from :func:`keys_to_sames`.  Returns T
    [NF, K//2, 2*TW] int32: per fragment the inclusive scan
    acc_j = madd(same_j ? acc_{j-1} : identity, row_j), steps (2i, 2i+1)
    side by side in row i.  Launches csrc/scan.cu on CUDA tensors; CPU
    tensors take the plain version."""
    _build.capture("scan", rows, sames_t)
    if not _build.on_cuda(rows, sames_t):
        return msm_scan_rm_sames_plain(rows, sames_t)
    return _launch_rm("scan", "scan", "msm_scan_rm_sames", rows, sames_t)


def msm_scan_rm_signed(rows: torch.Tensor, bits_t: torch.Tensor) -> torch.Tensor:
    """As :func:`msm_scan_rm_sames` over rows of the single (non-negated)
    table: bits_t [K, NF] int32 holds the same-as-previous bit in bit 0 and
    the digit's sign in bit 1; a negative entry adds the negated point (y-x
    and y+x swapped, 2*d*t negated).  Launches csrc/scan.cu on CUDA tensors;
    CPU tensors take the plain version."""
    _build.capture("scan_signed", rows, bits_t)
    if not _build.on_cuda(rows, bits_t):
        return msm_scan_rm_signed_plain(rows, bits_t)
    return _launch_rm("scan_signed", "scan", "msm_scan_rm_signed", rows, bits_t)


def msm_scan(rows: torch.Tensor, keys_t: torch.Tensor) -> torch.Tensor:
    """As :func:`msm_scan_rm_sames` with the sorted bucket keys keys_t
    [K, NF] int32 in place of the same bits: the kernel compares each key
    with the previous step's (-1 before a fragment's first step).  Launches
    csrc/scan_variants.cu on CUDA tensors; CPU tensors take the plain
    version."""
    _build.capture("scan_keys", rows, keys_t)
    if not _build.on_cuda(rows, keys_t):
        return msm_scan_plain(rows, keys_t)
    return _launch_rm("scan_keys", "scan_variants", "msm_scan_keys", rows, keys_t)


def msm_scan_pret(rows_t: torch.Tensor, keys_t: torch.Tensor) -> torch.Tensor:
    """As :func:`msm_scan` over the limb-major layout rows_t
    [NF//lblk, K, 64, lblk] int32: word i of step j's row of fragment
    b*lblk + l at [b, j, i, l] (the first 64 words of each row).  Launches
    csrc/scan_variants.cu on CUDA tensors; CPU tensors take the plain
    version."""
    _build.capture("scan_pret_keys", rows_t, keys_t)
    if not _build.on_cuda(rows_t, keys_t):
        return msm_scan_pret_plain(rows_t, keys_t)
    return _launch_pret("scan_pret_keys", "msm_scan_pret_keys", rows_t, keys_t)


def msm_scan_sames(rows_t: torch.Tensor, sames_t: torch.Tensor) -> torch.Tensor:
    """As :func:`msm_scan_rm_sames` over the limb-major layout of
    :func:`msm_scan_pret`.  Launches csrc/scan_variants.cu on CUDA tensors;
    CPU tensors take the plain version."""
    _build.capture("scan_pret", rows_t, sames_t)
    if not _build.on_cuda(rows_t, sames_t):
        return msm_scan_sames_plain(rows_t, sames_t)
    return _launch_pret("scan_pret", "msm_scan_pret_sames", rows_t, sames_t)


def msm_scan_signed(rows_t: torch.Tensor, bits_t: torch.Tensor) -> torch.Tensor:
    """As :func:`msm_scan_rm_signed` over the limb-major layout of
    :func:`msm_scan_pret`.  Launches csrc/scan_variants.cu on CUDA tensors;
    CPU tensors take the plain version."""
    _build.capture("scan_pret_signed", rows_t, bits_t)
    if not _build.on_cuda(rows_t, bits_t):
        return msm_scan_signed_plain(rows_t, bits_t)
    return _launch_pret("scan_pret_signed", "msm_scan_pret_signed", rows_t, bits_t)


def msm_scan_rm_sames_q(rows: torch.Tensor, sames_t: torch.Tensor) -> torch.Tensor:
    """As :func:`msm_scan_rm_sames`, storing only steps 4i+2 and 4i+3:
    returns [NF, K//4, 2*TW] int32, row i holding those two steps side by
    side (extraction replays steps 4i and 4i+1, ec.py::
    extract_reconstruct_rows).  Launches csrc/scan_variants.cu on CUDA
    tensors; CPU tensors take the plain version."""
    _build.capture("scan_q", rows, sames_t)
    if not _build.on_cuda(rows, sames_t):
        return msm_scan_rm_sames_q_plain(rows, sames_t)
    return _launch_rm("scan_q", "scan_variants", "msm_scan_rm_sames_q", rows, sames_t, store=4)


def msm_scan_fused(table: torch.Tensor, pidx_t: torch.Tensor, keys_t: torch.Tensor) -> torch.Tensor:
    """As :func:`msm_scan`, reading step j of fragment f from table row
    pidx_t[j, f] (table [ns, TWR] int32, pidx_t [K, NF] int32 rows in
    [0, ns), of any strides): the gather fused into the scan.  Launches
    csrc/scan.cu on CUDA tensors; CPU tensors take the plain version."""
    _build.capture("scan_fused", table, pidx_t, keys_t)
    if not _build.on_cuda(table, pidx_t, keys_t):
        return msm_scan_fused_plain(table, pidx_t, keys_t)
    return _launch_table("scan_fused", "scan", "msm_scan_fused", table, pidx_t, keys_t)


# ---------------------------------------------------------------------------
# Hierarchical carry scan: C_{f+1} = a_f * C_f + b_f (exclusive, C_0 = id).


def ab_scan_level_plain(a: torch.Tensor, b: torch.Tensor, kab: int):
    """Plain version of :func:`ab_scan_level`."""
    n = a.shape[0]
    nc = n // kab
    c = load_consts(a.device)
    a2 = a.reshape(nc, kab)
    b3 = b.reshape(nc, kab, TW)
    ident = pt_identity(nc, c)
    acc = ident
    apre = torch.ones(nc, dtype=torch.int32, device=a.device)
    c_rows, apres = [], []
    for j in range(kab):
        c_rows.append(pt_to_rows(acc))
        apres.append(apre)
        aj = a2[:, j] != 0
        acc = full_add(pt_select(aj, acc, ident), rows_to_pt(b3[:, j]), c)
        apre = torch.where(aj, apre, torch.zeros_like(apre))
    return (torch.stack(c_rows, dim=1).reshape(n, TW), torch.stack(apres, dim=1).reshape(n),
            apre, pt_to_rows(acc))


def ab_scan_level(a: torch.Tensor, b: torch.Tensor, kab: int):
    """One level over chunks of kab fragments: a [N] int32 (0/1), b [N, TW]
    int32 packed points, N divisible by kab.  Returns (c_local [N, TW]
    exclusive scan within each chunk, apre [N] exclusive prefix-AND of a
    within each chunk, a_agg [N//kab], b_agg [N//kab, TW]).  Launches
    csrc/scan.cu on CUDA tensors; CPU tensors take the plain version."""
    n = a.shape[0]
    if n % kab:
        raise ValueError(f"N={n} is not a multiple of kab={kab}")
    _build.capture("ab_scan", a, b, kab)
    if not _build.on_cuda(a, b):
        return ab_scan_level_plain(a, b, kab)
    nc = n // kab
    a = _build.check(a.to(torch.int32), torch.int32, (n,), "a")
    b = _build.check(b, torch.int32, (n, TW), "b")
    c_loc = torch.empty((n, TW), dtype=torch.int32, device=a.device)
    apre = torch.empty((n,), dtype=torch.int32, device=a.device)
    a_agg = torch.empty((nc,), dtype=torch.int32, device=a.device)
    b_agg = torch.empty((nc, TW), dtype=torch.int32, device=a.device)
    _build.launch("ab_scan", "scan", "msm_ab_scan_level", a, b, c_loc, apre, a_agg, b_agg,
                  nc, kab)
    return c_loc, apre, a_agg, b_agg


def seg_carry_scan(a: torch.Tensor, b: torch.Tensor, kab: int = K) -> torch.Tensor:
    """Exclusive linear scan C_{f+1} = a_f*C_f + b_f over [N] fragments:
    a [N] int32 (0/1), b [N, TW] packed points -> C [N, TW].  The levels,
    their padding to <= 128 or a multiple of 128 chunks, and the order of the
    adds are the JAX package's, so the carries match it bit for bit."""
    n = a.shape[0]
    if n <= kab:
        return ab_scan_level(a, b, n)[0]
    nc = -(-n // kab)
    if nc > 128:
        nc = -(-nc // 128) * 128
    target = nc * kab
    if target != n:
        pad = target - n
        a = torch.cat([a, torch.zeros((pad,), dtype=a.dtype, device=a.device)])
        b = torch.cat([b, b[-1:].expand(pad, b.shape[1])])
        return seg_carry_scan(a, b, kab)[:n]
    c_loc, apre, a_agg, b_agg = ab_scan_level(a, b, kab)
    cin = seg_carry_scan(a_agg, b_agg, kab)                         # [N//kab, TW]
    return masked_add_rows(c_loc, cin.repeat_interleave(kab, dim=0), apre)
