"""SDDMM-style similarity ops and blockwise global top-k.

Port of ``noise_gnn_tpu/ops/sddmm.py``. The similarity matrix ``h @ h.T``
stays implicit: per-edge cosines take E values, and the global top-k runs
over row blocks with a running top-k merge, O(block * N) memory.

Every top-k here is :func:`stable_topk`, which returns what
``jax.lax.top_k`` returns: the k largest values in descending order in the
total order of floats (-0.0 < 0.0), equal values in ascending index order.
The rewiring picks edges by these ranks, and the sampled tree repeats node
ids, so equal similarities are common; ``torch.topk`` promises no order
among them. So the helper ranks a unique int64 key per element: the
float's order-preserving int32 image in the high word and the complement
of its index in the low word (on a card, one pass of a hand-written
kernel, :func:`topk_keys`).

The similarity products are f32 matmuls. They need
``torch.get_float32_matmul_precision() == 'highest'`` (torch's default; no
TF32) to pick the edges the JAX package picks. Where N and the row block
are whole 128-row tiles, the rewire takes its segment maxima and chosen
segments from the hand-written kernels of ``csrc/rewire_sim.cu``
(:func:`segment_extrema`, :func:`segment_values`; see the fused route
below), and the similarity blocks never reach memory.
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import math
from pathlib import Path

import torch

from .cuda_build import CSRC, build_library

_LOW = (1 << 32) - 1


def l2_normalize(h: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt((h * h).sum(dim=-1, keepdim=True))
    return h / n.clamp(min=eps)


def sddmm_cosine(h: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
    """Cosine similarity per edge: sim[e] = <h_norm[src_e], h_norm[dst_e]>."""
    hn = l2_normalize(h)
    return (hn[edge_index[0].long()] * hn[edge_index[1].long()]).sum(dim=-1)


def order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 image of f32 ``x`` whose integer order is the floats' total
    order (-0.0 below 0.0; XLA's top-k comparison)."""
    b = x.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _keys_plain(x: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    return order_key(x).long() * (1 << 32) + (_LOW - idx)


def topk_keys(x: torch.Tensor) -> torch.Tensor:
    """The unique int64 key of each entry of f32 ``x``, whose order along
    the last axis is :func:`stable_topk`'s: the order key in the high word,
    the complement of the index in the low word. On a card one pass of the
    keys kernel (``csrc/rewire_sim.cu``); on the CPU torch ops."""
    if x.dtype != torch.float32:
        raise TypeError(f"stable_topk ranks float32, got {x.dtype}")
    if x.device.type == "cpu":
        return _keys_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    key = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    err = _load().ngt_topk_keys(x.data_ptr(), x.shape[-1], x.numel(), key.data_ptr(),
                                _device_index(x), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"top-k keys kernel launch failed: cudaError {err}")
    launch_counts["keys"] += 1
    return key


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices int64) of the ``k`` largest entries of f32 ``x``
    along its last axis (each row on its own), as ``jax.lax.top_k``:
    descending, ties in ascending index order."""
    top = torch.topk(topk_keys(x), k, sorted=True).values
    i = _LOW - (top & _LOW)
    return x.gather(-1, i), i


def _segment_max(segs: torch.Tensor) -> torch.Tensor:
    """Row maxima of [S, seg] f32 in the total order (-0.0 below +0.0, as
    XLA's reduction ranks them; ``amax`` may return either zero), in one
    pass and without a host sync. As int32, a float with the sign bit clear
    orders as the float does, and a negative one orders by its magnitude: so
    a row's maximum is its largest int32 image if that is >= 0, else its
    smallest."""
    lo, hi = torch.aminmax(segs.view(torch.int32), dim=1)
    return torch.where(hi >= 0, hi, lo).view(torch.float32)


def hier_flat(n: int, k: int, seg: int = 128) -> bool:
    """Whether :func:`hier_topk` takes a plain top-k of an array of ``n``
    (too small for the hierarchy to pay)."""
    return n <= max(4 * seg, 4 * k)


def select_segments(seg_max: torch.Tensor, k: int) -> torch.Tensor:
    """The hierarchy's first stage: the ids of the top-k segments by their
    maxima (ties to the lower id), in that order; along the last axis."""
    return stable_topk(seg_max, min(k, seg_max.shape[-1]))[1]


def pick_from_segments(cand: torch.Tensor, si: torch.Tensor, n: int, k: int):
    """The hierarchy's second stage: the top-k of the chosen segments'
    values ``cand`` [..., len(si), seg], laid out segment by segment in
    the order of ``si`` [..., len(si)], as (values, flat indices into the
    array of ``n``); leading axes are arrays of their own."""
    seg = cand.shape[-1]
    flat = cand.reshape(*cand.shape[:-2], -1)
    vals, ci = stable_topk(flat, min(k, flat.shape[-1]))
    idx = si.gather(-1, torch.div(ci, seg, rounding_mode="floor")) * seg + ci % seg
    return vals, idx.clamp(max=n - 1)


def hier_topk(flat: torch.Tensor, k: int, seg: int = 128):
    """Exact top-k of a large 1-D array via a segment-max hierarchy
    (JAX ``ops/sddmm.py::hier_topk``, step for step): per-segment maxima,
    the top-k segments by their maxima, then the top-k of those segments'
    elements laid out segment by segment in that order. Ties therefore go
    to the earlier segment in that layout. Exact: at most k segments can
    hold an element >= the k-th largest. -inf winners (fewer than k real
    entries) may point into the padding; their index is clamped to n - 1."""
    n = flat.shape[0]
    if hier_flat(n, k, seg):
        return stable_topk(flat, min(k, n))
    pad = (-n) % seg
    if pad:
        flat = torch.cat([flat, torch.full((pad,), float("-inf"), dtype=flat.dtype,
                                           device=flat.device)])
    segs = flat.view(-1, seg)
    si = select_segments(_segment_max(segs), k)
    return pick_from_segments(segs[si], si, n, k)


def merge_topk(vals, rows, cols, new_vals, new_rows, new_cols, k: int):
    """The running top-k: the k largest of the carry followed by a new
    block (so the carry wins ties)."""
    mv, mi = stable_topk(torch.cat([vals, new_vals]), k)
    return mv, torch.cat([rows, new_rows])[mi], torch.cat([cols, new_cols])[mi]


def blockwise_topk(h_norm: torch.Tensor, k: int, mask_fn, largest: bool = True,
                   block: int = 1024):
    """Top-k entries of (h_norm @ h_norm.T) under a caller-supplied mask.

    mask_fn(row_start, row_ids [B], sim [B, N]) -> sim with excluded entries
    set to -inf (for smallest-k the similarities are negated first).
    Returns (values [k], rows [k], cols [k]) with rows and cols int64."""
    n = h_norm.shape[0]
    block = min(block, n)
    nblocks = -(-n // block)
    hp = padded_rows(h_norm, block)
    sign = 1.0 if largest else -1.0
    dev = h_norm.device
    vals = torch.full((k,), float("-inf"), dtype=torch.float32, device=dev)
    rows = torch.zeros(k, dtype=torch.int64, device=dev)
    cols = torch.zeros(k, dtype=torch.int64, device=dev)
    for i in range(nblocks):
        row0 = i * block
        sim = (hp[row0:row0 + block] @ h_norm.T).float() * sign
        row_ids = row0 + torch.arange(block, device=dev)
        sim = torch.where((row_ids < n)[:, None], sim, float("-inf"))
        sim = mask_fn(row0, row_ids, sim)
        bv, bc = hier_topk(sim.reshape(-1), k)
        width = sim.shape[1]
        vals, rows, cols = merge_topk(vals, rows, cols, bv,
                                      row0 + torch.div(bc, width, rounding_mode="floor"),
                                      bc % width, k)
    return vals * sign, rows, cols


# ------------------------------------------------------- the rewire's fused route
#
# The rewire's sweep (``augment/rewire.py``) needs, per row block and sign,
# only the maxima of its [block, N] similarity block over 128-column
# segments and then the values of the k segments they select. Where N and
# the block are multiples of SEG, every segment lies inside one row, and
# both come from the hand-written kernels of ``csrc/rewire_sim.cu``: the
# block never reaches memory. On a CPU tensor the same functions run their
# plain versions below, which form the sweep's own product
# ``hp[row0:row0 + block] @ hn.T`` and are bit-equal to it. The kernels'
# one FMA chain per similarity is cuBLAS's product at the main paths'
# shapes (the TE step's [2048, 256] x [256, 159,232], the H step's [2048,
# 128] x [128, 31,232]), so there the card's picks are the block sweep's
# too; where cuBLAS splits k, as at [512, 256] x [256, 1280], its product
# differs from the chain by a few ulp. The exclusions of row r are the
# diagonal and ``excl[r]`` (the one other excluded column, -1 for none);
# rows past N are -inf whole; the neg sign ranks -sim.

SEG = 128  # the hierarchy's segment width and the kernels' tile side
BAND = 8  # row tiles of one band of the extrema kernel's schedule

_SIM_SRC = CSRC / "rewire_sim.cu"

# Launches by kernel ("extrema", "values", "sim", "keys"), counted where the
# wrappers launch and nowhere else (the plain versions never count).
launch_counts: collections.Counter = collections.Counter()

_lib = None


def build() -> Path:
    """Compile ``csrc/rewire_sim.cu`` unless it is built already."""
    return build_library(_SIM_SRC, "ngt_rewire_sim")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ngt_rewire_extrema.argtypes = [vp, i64, i64, i64, i64, i64, i64, i64, vp, vp, vp,
                                           vp, vp, i32, vp]
        lib.ngt_rewire_values.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, i64, i64, i64,
                                          vp, i32, vp]
        lib.ngt_topk_keys.argtypes = [vp, i64, i64, vp, i32, vp]
        for f in (lib.ngt_rewire_extrema, lib.ngt_rewire_values, lib.ngt_topk_keys):
            f.restype = ctypes.c_int
        _lib = lib
    return _lib


def padded_rows(hn: torch.Tensor, block: int) -> torch.Tensor:
    """``hn`` with zero rows up to a whole number of ``block``-row blocks:
    the sweep's left operand."""
    n = hn.shape[0]
    return torch.nn.functional.pad(hn, (0, 0, 0, -(-n // block) * block - n))


def exclude_(s: torch.Tensor, row0: int, excl: torch.Tensor) -> torch.Tensor:
    """Set the excluded entries of the similarity block ``s`` [block, N]
    of rows ``row0 ...`` to -inf, in place: rows past N whole, then each
    row's diagonal and its ``excl`` column."""
    block, n = s.shape
    local = torch.arange(block, device=s.device)
    rid = (row0 + local).clamp(max=n - 1)
    s[n - row0:] = float("-inf")
    s[local, rid] = float("-inf")
    e = excl[rid]
    s[local, torch.where(e >= 0, e, rid)] = float("-inf")
    return s


def _check_rows(hn: torch.Tensor, block: int) -> int:
    if hn.dim() != 2 or hn.dtype != torch.float32:
        raise TypeError(f"hn must be [N, D] float32, got {tuple(hn.shape)} {hn.dtype}")
    if not hn.is_contiguous():
        raise ValueError("hn must be contiguous")
    n = hn.shape[0]
    if n % SEG or block % SEG or block <= 0:
        raise ValueError(f"N ({n}) and the block ({block}) must be multiples of {SEG}")
    return n // SEG


def _extrema_plain(hn, blocks: range, block: int, excl_pos, excl_neg):
    t = hn.shape[0] // SEG
    hp = padded_rows(hn, block)
    ext_pos = torch.empty((len(blocks) * block, t), dtype=torch.float32, device=hn.device)
    ext_neg = torch.empty_like(ext_pos) if excl_neg is not None else None
    for j, i in enumerate(blocks):
        row0 = i * block
        s = hp[row0:row0 + block] @ hn.T
        out = slice(j * block, (j + 1) * block)
        if ext_neg is not None:
            ext_neg[out] = _segment_max(exclude_(-s, row0, excl_neg).view(-1, SEG)).view(block, t)
        ext_pos[out] = _segment_max(exclude_(s, row0, excl_pos).view(-1, SEG)).view(block, t)
    return ext_pos, ext_neg


def tile_count(t_lo: int, t_hi: int, t: int, band: int = BAND) -> int:
    """The tiles of the extrema kernel's work list for the row tiles
    [t_lo, t_hi) of ``t``: per band of ``band`` row tiles (nI of them from
    I0), the triangle I <= J < I0 + nI and nI tiles for each J outside the
    range or past the band."""
    total = 0
    for i0 in range(t_lo, t_hi, band):
        ni = min(band, t_hi - i0)
        total += ni * (ni + 1) // 2 + ni * (t_lo + t - i0 - ni)
    return total


def tile_of(k: int, t_lo: int, t_hi: int, t: int, band: int = BAND) -> tuple[int, int]:
    """The k-th tile (I, J) of the extrema kernel's work list, as the kernel
    finds it (``band_tile`` in ``csrc/rewire_sim.cu``): bands of ``band``
    row tiles from t_lo, band-major; in a band (row tiles I0 ... I0 + nI -
    1) first the triangle J in [I0, I0 + nI), I <= J, J-major, then each J
    of [0, t_lo) and [I0 + nI, t), nI tiles, J-major. A tile (I, J) with J
    in the range and J != I gives its column extrema to row tile J. A full
    band holds a - b g tiles, so the band of k is found from a quadratic."""
    a, b = band * (band + 1) // 2 + band * (t - band), band * band
    full = (t_hi - t_lo) // band

    def off(g):
        return g * a - b * g * (g - 1) // 2

    g = full
    if k < off(full):
        h = a + 0.5 * b
        g = min(max(int((h - math.sqrt(h * h - 2.0 * b * k)) / b), 0), full - 1)
        while g + 1 < full and off(g + 1) <= k:
            g += 1
        while g > 0 and off(g) > k:
            g -= 1
    i0 = t_lo + g * band
    ni = min(band, t_hi - i0)
    u = k - off(g)
    if u < ni * (ni + 1) // 2:
        jj = 0
        while (jj + 1) * (jj + 2) // 2 <= u:
            jj += 1
        return i0 + u - jj * (jj + 1) // 2, i0 + jj
    u -= ni * (ni + 1) // 2
    col = u // ni
    return i0 + u % ni, (col if col < t_lo else i0 + ni + col - t_lo)


def _device_index(x: torch.Tensor) -> int:
    return x.device.index if x.device.index is not None else torch.cuda.current_device()


def segment_extrema(hn: torch.Tensor, blocks: range, block: int, excl_pos: torch.Tensor,
                    excl_neg: torch.Tensor | None = None, hnt: torch.Tensor | None = None):
    """(ext_pos, ext_neg or None), each [len(blocks) * block, N / SEG]: per
    row of the row blocks ``blocks`` and per SEG-column segment, the maximum
    of sim = hn hn^T (pos) and of -sim (neg), excluded entries -inf, in the
    floats' total order: ``_segment_max`` of the sweep's blocks. On a card
    the extrema kernel (``hnt``: ``hn.T`` contiguous, made here if not
    given); on the CPU the plain version."""
    t = _check_rows(hn, block)
    if hn.device.type == "cpu":
        return _extrema_plain(hn, blocks, block, excl_pos, excl_neg)
    if hn.device.type != "cuda":
        raise ValueError(f"unsupported device {hn.device}")
    n, rows = hn.shape[0], len(blocks) * block
    hnt = hn.T.contiguous() if hnt is None else hnt
    row0 = blocks.start * block
    ext_pos = torch.empty((rows, t), dtype=torch.float32, device=hn.device)
    ext_neg = torch.empty_like(ext_pos) if excl_neg is not None else None
    for e in (ext_pos, ext_neg):
        if e is not None:
            e[max(n - row0, 0):] = float("-inf")  # rows past N
    real = min(blocks.stop * block, n) - row0
    if real <= 0:
        return ext_pos, ext_neg
    ntiles = tile_count(row0 // SEG, (row0 + real) // SEG, t, BAND)
    ex = [e.to(torch.int32).contiguous() for e in (excl_pos, excl_neg) if e is not None]
    err = _load().ngt_rewire_extrema(
        hnt.data_ptr(), ntiles, BAND, n, int(hn.shape[1]), row0, row0 + real, 0,
        ex[0].data_ptr(), ex[1].data_ptr() if len(ex) > 1 else None,
        ext_pos.data_ptr(), ext_neg.data_ptr() if ext_neg is not None else None, None,
        _device_index(hn), torch.cuda.current_stream(hn.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rewire extrema kernel launch failed: cudaError {err}")
    launch_counts["extrema"] += 1
    return ext_pos, ext_neg


def similarity_rows(hn: torch.Tensor, row0: int, rows: int,
                    hnt: torch.Tensor | None = None) -> torch.Tensor:
    """sim [rows, N] of rows ``row0 ...`` (< N) from the extrema kernel's
    own product, written out (a card-only check of its arithmetic against
    ``hn[rows] @ hn.T``)."""
    t = _check_rows(hn, SEG)
    n = hn.shape[0]
    if hn.device.type != "cuda":
        raise ValueError("similarity_rows runs the kernel: it needs a CUDA tensor")
    if row0 % SEG or rows % SEG or row0 + rows > n:
        raise ValueError(f"rows [{row0}, {row0 + rows}) must be whole tiles inside [0, {n})")
    hnt = hn.T.contiguous() if hnt is None else hnt
    out = torch.empty((rows, n), dtype=torch.float32, device=hn.device)
    err = _load().ngt_rewire_extrema(
        hnt.data_ptr(), rows // SEG * t, BAND, n, int(hn.shape[1]), row0, row0 + rows, 1,
        None, None, None, None, out.data_ptr(), _device_index(hn),
        torch.cuda.current_stream(hn.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rewire similarity kernel launch failed: cudaError {err}")
    launch_counts["sim"] += 1
    return out


def _values_plain(hn, blocks: range, block: int, picks):
    hp = padded_rows(hn, block)
    out = [[] for _ in picks]
    for j, i in enumerate(blocks):
        s = hp[i * block:(i + 1) * block] @ hn.T
        for o, (si, excl, neg) in zip(out, picks):
            o.append(exclude_(-s if neg else s.clone(), i * block, excl).view(-1, SEG)[si[j]])
    return [torch.stack(o) for o in out]


def value_chunks(segs: torch.Tensor, t: int, chunk: int = 64):
    """The values kernel's work list for entries whose column tiles are
    ``segs``: (order, chunk starts, chunk lengths) with ``order`` sorting
    the entries by column tile (stably), and each chunk at most ``chunk``
    consecutive sorted entries of one column tile. Sized for the most
    chunks ``len(segs)`` entries can take, unused chunks of length 0, so
    nothing waits for the device."""
    m, dev = segs.shape[0], segs.device
    order = torch.argsort(segs, stable=True)
    s = segs[order]
    counts = torch.bincount(segs, minlength=t)
    nch = torch.div(counts + chunk - 1, chunk, rounding_mode="floor")
    ch0 = torch.cumsum(nch, 0) - nch
    pos = torch.arange(m, device=dev) - (torch.cumsum(counts, 0) - counts)[s]
    ids = ch0[s] + torch.div(pos, chunk, rounding_mode="floor")
    first = pos % chunk == 0
    size = -(-m // chunk) + t
    starts = torch.zeros(size, dtype=torch.int32, device=dev)
    lens = torch.zeros(size, dtype=torch.int32, device=dev)
    starts[ids[first]] = torch.arange(m, device=dev)[first].to(torch.int32)
    lens[ids[first]] = torch.clamp(counts[s[first]] - pos[first], max=chunk).to(torch.int32)
    return order, starts, lens


def segment_values(hn: torch.Tensor, blocks: range, block: int, picks,
                   hnt: torch.Tensor | None = None) -> list[torch.Tensor]:
    """The values of chosen segments of the row blocks ``blocks``, one
    [len(blocks), k, SEG] per (si, excl, neg) of ``picks`` (si [len(blocks),
    k]: each block's flat segment ids of its [block, N] view, as
    :func:`select_segments` gives them; excl and neg as for
    :func:`segment_extrema`): bit-equal to the sweep's ``segs[si]``. On a
    card the values kernel, all picks in one launch; on the CPU the plain
    version."""
    t = _check_rows(hn, block)
    if hn.device.type == "cpu":
        return _values_plain(hn, blocks, block, picks)
    if hn.device.type != "cuda":
        raise ValueError(f"unsupported device {hn.device}")
    n, dev = hn.shape[0], hn.device
    hnt = hn.T.contiguous() if hnt is None else hnt
    row0 = torch.arange(blocks.start, blocks.stop, device=dev)[:, None] * block
    shapes = [p[0].shape for p in picks]
    rows = torch.cat([(row0 + torch.div(p[0], t, rounding_mode="floor")).reshape(-1)
                      for p in picks])
    segs = torch.cat([(p[0] % t).reshape(-1) for p in picks])
    rid = rows.clamp(max=n - 1)
    sizes = [s.numel() for s in shapes]
    excl = torch.cat([p[1][rid[a:a + m]] for p, a, m in
                      zip(picks, itertools.accumulate([0] + sizes), sizes)])
    neg = torch.cat([torch.full((m,), int(p[2]), dtype=torch.int32, device=dev)
                     for p, m in zip(picks, sizes)])
    order, starts, lens = value_chunks(segs, t)
    # sorted entries, each with its row of the output (its place in ``picks``)
    ent = [x[order].to(torch.int32).contiguous() for x in (rows, segs, excl, neg)]
    ent.append(order.to(torch.int32))
    out = torch.empty((rows.shape[0], SEG), dtype=torch.float32, device=dev)
    err = _load().ngt_rewire_values(
        hn.data_ptr(), hnt.data_ptr(), *(x.data_ptr() for x in ent), starts.data_ptr(),
        lens.data_ptr(), int(starts.shape[0]), n, int(hn.shape[1]), out.data_ptr(),
        _device_index(hn), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rewire values kernel launch failed: cudaError {err}")
    launch_counts["values"] += 1
    return [o.view(*shp, SEG) for o, shp in zip(out.split(sizes), shapes)]
