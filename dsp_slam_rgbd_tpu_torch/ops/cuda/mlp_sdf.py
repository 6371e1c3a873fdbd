"""Fused DeepSDF decoder kernels: value, and value + input Jacobian.

Counterpart of `dsp_slam_rgbd_tpu/ops/pallas/mlp_sdf.py`.  The two Pallas
TPU kernels (`_make_kernel`, `_make_value_kernel`) are CUDA C++ for
sm_90a: in bf16 on the tensor cores (`csrc/mlp_sdf_value_tc.cuh`,
`csrc/mlp_sdf_jacobian_tc.cuh`), in f32 (the mode `ReconConfig()` runs) on
the FMA pipes (`csrc/mlp_sdf_f32.cuh`), with the C routing in
`csrc/mlp_sdf.cu`.  They are compiled for two decoder layouts (`LAYOUTS`),
each 8 hidden layers of 512 with the input re-injected at layer 4 and a
final tanh: DSP-SLAM's cars/chairs_64 (latent 64; `csrc/mlp_sdf_*.cu`) and
DeepSDF's published ShapeNet setting (latent 256; `csrc/mlp_sdf256_*.cu`).
This module packs the weights, checks and flattens the inputs, launches the
kernels, and keeps beside each one its plain PyTorch version (the CPU route
and the reference the card is held to).

Packed layout (as on the TPU): w0 (in_pad, 512) for layer 0 over the input
rows [code L | xyz 3 | 0] (in_pad 128 at L = 64, 384 at 256); W (8, 512,
512) for layers 1..8, layer 3's 512 − (L + 3) real output columns (445 or
253) padded with zeros and layer 8's single output in column 0; b (9,
512).  Before layer 4 the raw (L + 3)-d input is written into the columns
past layer 3's real ones (the decoder's latent re-injection).

Every kernel reads its weights as host-packed streams, the exact
shared-memory image of each slot of its weight ring: in bf16 the forward
sweep w0 and W[0..6] as `pack_value_tiles` lays them out, the Jacobian's
backward sweep W[6]ᵀ..W[0]ᵀ and w0ᵀ as `pack_backward_tiles` does; in f32
the same sweeps as `pack_value_tiles_f32` and `pack_backward_tiles_f32`
lay them out.  At latent 256 the bf16 kernels fold the code's products
(`Layout.fold`): the forward stream's layer 0 covers xyz alone, and a fold
kernel before each launch forms every code's product with layer 0's and
layer 4's code rows, which the layers add as a per-code bias.

Batching: code may be one shared (L,) code, per-row (N, L) codes, or
per-object (B, L) codes over xyz (B, N, 3); every form is one launch over
all rows, with row g reading code[g // rows_per_code].

Routing: a CUDA tensor launches the kernel (or raises); a CPU tensor runs
the plain version.  Nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dsp_slam_rgbd_tpu_torch.ops.cuda import build

D = 512
N_LAYERS = 9
VALUE_KC = 64                                  # K rows of a layer per bf16 stage
VALUE_STAGE_BYTES = VALUE_KC * D * 2           # one stage: 64 K x 512 outputs, bf16
BACKWARD_STAGES = (N_LAYERS - 2) * D // VALUE_KC   # 56 stages of W[6]ᵀ..W[0]ᵀ
W0T_STAGES = D // VALUE_KC                     # then 8 stages of w0ᵀ
# The f32 streams: 128-column blocks, block-major over the whole stream, so
# that a cluster CTA's column slice of any run of rows is one contiguous copy
# per block; within a block, position 4 l + j holds column l + 32 j (lane l's
# four columns, one float4).
F32_BLOCK = 128                                # columns of an f32 block
F32_BWD_ROWS = (N_LAYERS - 2) * D              # W[6]ᵀ..W[0]ᵀ: 3,584, then w0ᵀ


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


class Layout(NamedTuple):
    """A decoder layout the kernels are compiled for (8 x 512, latent_in
    (4,), final tanh) and the shapes of its packed weights and streams."""
    latent: int
    in_dim: int            # code + xyz
    split: int             # layer-3 real output width (D − in_dim)
    in_pad: int            # rows of the packed w0: whole 128-column blocks of w0ᵀ
    fold: bool             # bf16: the code's layer-0 and layer-4 products per code
    value_k0: int          # layer-0 rows of the bf16 forward stream
    value_skip: tuple      # (first, count) of layer 4's K chunks the bf16 stream leaves out
    w0t_cols: int          # outputs of the bf16 Jacobian's last product (g w0ᵀ)
    f32_k0: int            # layer-0 rows of the f32 forward stream
    value_stages: int
    w0t_stage_bytes: int
    backward_bytes: int
    f32_value_floats: int
    f32_backward_floats: int


def _layout(latent: int) -> Layout:
    in_dim = latent + 3
    fold = _up(in_dim, VALUE_KC) > 2 * VALUE_KC    # the row tile would pass 16 KB
    value_k0 = VALUE_KC if fold else _up(in_dim, VALUE_KC)
    # folded, layer 4's input is 0 in the code's columns: the K chunks that
    # hold nothing else are left out of the stream and the product
    split = D - in_dim
    skip_at = -(-split // VALUE_KC) if fold else 0
    skip = (split + latent) // VALUE_KC - skip_at if fold else 0
    w0t_cols = _up(in_dim, VALUE_KC)
    in_pad = _up(in_dim, F32_BLOCK)
    f32_k0 = _up(in_dim, 16)
    w0t_stage = VALUE_KC * w0t_cols * 2
    return Layout(latent, in_dim, split, in_pad, fold, value_k0, (skip_at, skip), w0t_cols,
                  f32_k0, (value_k0 + (N_LAYERS - 2) * D) // VALUE_KC - skip, w0t_stage,
                  BACKWARD_STAGES * VALUE_STAGE_BYTES + W0T_STAGES * w0t_stage,
                  (D // F32_BLOCK) * (f32_k0 + (N_LAYERS - 2) * D) * F32_BLOCK,
                  (D // F32_BLOCK) * F32_BWD_ROWS * F32_BLOCK + D * in_pad)


# the compiled layouts: DSP-SLAM's cars/chairs_64 and DeepSDF's published
# ShapeNet setting (`examples/chairs/specs.json`: CodeLength 256)
LAYOUTS = {latent: _layout(latent) for latent in (64, 256)}
LAYOUT_NAMES = ("the cars/chairs_64 layout (latent 64) or DeepSDF's ShapeNet layout "
                "(latent 256), each with 8x512 dims and latent_in=(4,)")

# the cars/chairs_64 layout's stream sizes
VALUE_STAGES = LAYOUTS[64].value_stages        # 58
W0T_STAGE_BYTES = LAYOUTS[64].w0t_stage_bytes  # 64 K x 128 outputs each
BACKWARD_BYTES = LAYOUTS[64].backward_bytes
F32_VALUE_FLOATS = LAYOUTS[64].f32_value_floats
F32_BACKWARD_FLOATS = LAYOUTS[64].f32_backward_floats
# the kernels' tilings, in the order of their C interface: (rows of a tile,
# CTAs of a cluster sharing it, each computing 512 / c columns)
F32_TILINGS = ((32, 1), (64, 2), (32, 2))

# launches per kernel (op x compute dtype: the bf16 kernels carry the bare
# op's name, the f32 ones "_f32") since the last reset; the plain versions
# count none
LAUNCHES = {"mlp_sdf_value": 0, "mlp_sdf_jacobian": 0, "mlp_sdf_value_f32": 0,
            "mlp_sdf_jacobian_f32": 0}
ROWS = dict(LAUNCHES)   # rows launched per kernel (each launch's n), same keys and reset


def kernel_name(op: str, compute_dtype) -> str:
    """The `LAUNCHES` key of op "mlp_sdf_value" / "mlp_sdf_jacobian" in
    compute_dtype."""
    return op if compute_dtype == torch.bfloat16 else op + "_f32"


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = ROWS[k] = 0


def compatible(spec) -> bool:
    """True when the decoder arch is one of the kernels' compiled layouts
    (`LAYOUTS`: latent 64 or 256, 8x512 hidden, latent_in=(4,))."""
    return (
        getattr(spec, "latent_size", None) in LAYOUTS
        and tuple(getattr(spec, "latent_in", ())) == (4,)
        and getattr(spec, "dims", None) is not None
        and tuple(spec.dims) == (512,) * 8
    )


def layout_of(w0) -> Layout:
    """The layout of packed weights, from w0's shape."""
    for lay in LAYOUTS.values():
        if tuple(w0.shape) == (lay.in_pad, D):
            return lay
    raise ValueError(f"packed w0 must be (128, 512) at latent 64 or (384, 512) at 256; "
                     f"got {tuple(w0.shape)}")


def pack_params(layers, spec):
    """Pack [(W_i (in, out), b_i (out,))] into f32 (w0 (in_pad, 512),
    W (8, 512, 512), b (9, 512)) on the layers' device.

    Raises ValueError for a decoder whose arch fits no compiled layout: it
    would silently zero-pad into one and return wrong SDF values.
    """
    if not compatible(spec) or len(layers) != N_LAYERS:
        raise ValueError(
            f"the fused decoder kernels require {LAYOUT_NAMES}; got "
            f"latent={getattr(spec, 'latent_size', None)} "
            f"dims={getattr(spec, 'dims', None)} "
            f"latent_in={getattr(spec, 'latent_in', None)}")
    dev = layers[0][0].device
    w0 = torch.zeros(LAYOUTS[spec.latent_size].in_pad, D, device=dev)
    W = torch.zeros(N_LAYERS - 1, D, D, device=dev)
    b = torch.zeros(N_LAYERS, D, device=dev)
    for i, (Wi, bi) in enumerate(layers):
        r, c = Wi.shape
        if i == 0:
            w0[:r, :c] = Wi
        else:
            W[i - 1, :r, :c] = Wi
        b[i, :c] = bi
    return w0, W, b


def cast_packed(wb, compute_dtype):
    """The packed weights in the kernels' operand dtype (bias stays f32)."""
    w0, W, b = wb
    return w0.to(compute_dtype), W.to(compute_dtype), b


def _swizzle128(t):
    """(stages, outputs, 64 K values) -> the same stages with the 16-byte
    chunk of K values 8c..8c+7 of output n at chunk position c ^ (n % 8)
    of n's 128-byte row (the 128-byte swizzle), flat."""
    s, rows, kc = t.shape
    t = t.reshape(s, rows, kc // 8, 8)
    n = torch.arange(rows, device=t.device)
    chunk = torch.arange(kc // 8, device=t.device)
    src = chunk[None, :] ^ (n % 8)[:, None]     # position p holds chunk p ^ (n % 8)
    t = torch.gather(t, 2, src[None, :, :, None].expand_as(t))
    return t.contiguous().reshape(-1)


def _check_bf16(w0, W, what):
    if w0.dtype != torch.bfloat16 or W.dtype != torch.bfloat16:
        raise ValueError(f"{what} tiles are bf16; got {w0.dtype}, {W.dtype}")


def pack_value_tiles(w0, W):
    """bf16 w0 (in_pad, 512) and W[0..6] -> the bf16 kernels' forward
    weight stream, flat (value_stages * VALUE_STAGE_BYTES / 2,).

    Stage s holds rows 64s..64s+63 of [w0'; W[0]; ...; W[6]] (one K chunk of
    one layer), transposed so that each output n is a 128-byte row of its
    64 K values (B K-major), in the 128-byte swizzle.  w0' is w0[:128] at
    latent 64 (the row tile [code | xyz | 0]); at 256 (folded) it is w0's
    3 xyz rows padded to 64 (the row tile [xyz | 0]), and W[3] (layer 4)
    leaves out its K chunks 4..6, rows of the code alone (`value_skip`).
    Each stage is one contiguous copy into shared memory; outputs 0..255
    and 256..511 are its two 32 KB halves.
    """
    _check_bf16(w0, W, "value")
    lay = layout_of(w0)
    mats = list(W[:N_LAYERS - 2])
    if lay.fold:
        w0 = torch.cat([w0[lay.latent:lay.in_dim],
                        w0.new_zeros(lay.value_k0 - 3, D)])
        at, n = lay.value_skip
        mats[3] = torch.cat([mats[3][:at * VALUE_KC], mats[3][(at + n) * VALUE_KC:]])
    rows = torch.cat([w0[:lay.value_k0]] + mats)                # (K, N)
    return _swizzle128(rows.reshape(lay.value_stages, VALUE_KC, D).transpose(1, 2))


def pack_backward_tiles(w0, W):
    """bf16 w0 (in_pad, 512) and W[0..6] -> the bf16 Jacobian kernel's
    backward weight stream, flat (backward_bytes / 2,).

    Step i of the backward sweep is g · W[i-1]ᵀ: the reduction runs over
    W[i-1]'s output index and its outputs are W[i-1]'s input rows, whose 64
    K values of one chunk are already contiguous.  So stage 8(6 - l) + c
    (l = 6..0, c = 0..7) holds, for each of the 512 outputs k, the 128-byte
    row W[l][k, 64c:64c+64], and stage 56 + c likewise w0[k, 64c:64c+64]
    for the w0t_cols outputs k of the last product (128 at latent 64, 16 KB
    stages; 320 at 256, 40 KB), all in the 128-byte swizzle of
    `pack_value_tiles`.
    """
    _check_bf16(w0, W, "backward")
    lay = layout_of(w0)
    nc = D // VALUE_KC
    mats = W[:N_LAYERS - 2].flip(0)                             # W[6], ..., W[0]
    t = mats.reshape(N_LAYERS - 2, D, nc, VALUE_KC).transpose(1, 2)  # (l, c, k, 64)
    t0 = w0[:lay.w0t_cols].reshape(lay.w0t_cols, nc, VALUE_KC).transpose(0, 1)  # (c, k, 64)
    return torch.cat([_swizzle128(t.reshape(BACKWARD_STAGES, D, VALUE_KC)), _swizzle128(t0)])


def _check_f32(w0, W, what):
    if w0.dtype != torch.float32 or W.dtype != torch.float32:
        raise ValueError(f"{what} f32 tiles are float32; got {w0.dtype}, {W.dtype}")


def _lane_order(t):
    """(rows, 128 b) -> (b, rows, 128): column blocks of 128, position
    4 l + j of a block's row holding its column l + 32 j."""
    rows, cols = t.shape
    t = t.reshape(rows, cols // F32_BLOCK, 4, 32).transpose(2, 3)   # (rows, b, l, j)
    return t.reshape(rows, cols // F32_BLOCK, F32_BLOCK).transpose(0, 1)


def pack_value_tiles_f32(w0, W):
    """f32 w0 (in_pad, 512) and W[0..6] -> the f32 kernels' forward weight
    stream, flat (f32_value_floats,): the rows of [w0[:f32_k0]; W[0]; ...;
    W[6]] (K, one row per input of a layer) in 4 blocks of 128 output
    columns, block b holding all rows of columns 128b..128b+127 in lane
    order (`_lane_order`).  f32_k0 is the input row padded to 16 (80 at
    latent 64, 272 at 256); w0's rows past the input are the packed zeros."""
    _check_f32(w0, W, "value")
    rows = torch.cat([w0[:layout_of(w0).f32_k0], W[:N_LAYERS - 2].reshape(-1, D)])
    return _lane_order(rows).contiguous().reshape(-1)


def pack_backward_tiles_f32(w0, W):
    """f32 w0 (in_pad, 512) and W[0..6] -> the f32 Jacobian kernel's
    backward weight stream, flat (f32_backward_floats,).

    Step i of the backward sweep is g · W[i-1]ᵀ, so its B operand is
    W[i-1]ᵀ: row k (W's output) holds W[i-1][:, k] over the outputs n (W's
    inputs).  The rows of W[6]ᵀ, ..., W[0]ᵀ (3,584) in 4 blocks of 128
    columns as `pack_value_tiles_f32` lays them out, then w0ᵀ (512 rows of
    in_pad columns) in in_pad / 128 blocks (1 at latent 64, 3 at 256)."""
    _check_f32(w0, W, "backward")
    mats = W[:N_LAYERS - 2].flip(0).transpose(1, 2).reshape(-1, D)
    return torch.cat([_lane_order(mats).contiguous().reshape(-1),
                      _lane_order(w0.T.contiguous()).contiguous().reshape(-1)])


# -- input handling -----------------------------------------------------------

def _flatten(code: torch.Tensor, xyz: torch.Tensor, latent: int):
    """-> (codes (C, latent), rows_per_code, xyz rows (n, 3), leading shape)."""
    lead = tuple(xyz.shape[:-1])
    if xyz.shape[-1] != 3 or xyz.dim() not in (2, 3):
        raise ValueError(f"xyz must be (N, 3) or (B, N, 3), got {tuple(xyz.shape)}")
    rows = xyz.reshape(-1, 3)
    n = rows.shape[0]
    if code.shape[-1] != latent:
        raise ValueError(f"code must have {latent} columns, got {tuple(code.shape)}")
    if code.dim() == 1:                                   # shared
        return code.reshape(1, latent), max(n, 1), rows, lead
    if tuple(code.shape[:-1]) == lead:                    # per row
        return code.reshape(-1, latent), 1, rows, lead
    if xyz.dim() == 3 and code.dim() == 2 and code.shape[0] == lead[0]:
        return code, max(lead[1], 1), rows, lead          # per object
    raise ValueError(f"code {tuple(code.shape)} does not match xyz {tuple(xyz.shape)}")


def _prepare(wb, compute_dtype, code, xyz):
    """Checks the packed weights and the inputs -> (layout, codes (C, L),
    rows_per_code, xyz rows (n, 3), leading shape)."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    w0, W, b = wb
    if tuple(W.shape) != (N_LAYERS - 1, D, D) or tuple(b.shape) != (N_LAYERS, D):
        raise ValueError("packed weights must be W (8, 512, 512), b (9, 512); got "
                         f"{tuple(W.shape)}, {tuple(b.shape)}")
    lay = layout_of(w0)
    codes, rpc, rows, lead = _flatten(code, xyz, lay.latent)
    if w0.dtype != compute_dtype or W.dtype != compute_dtype or b.dtype != torch.float32:
        raise ValueError(f"weights must be {compute_dtype} with an f32 bias; got "
                         f"{w0.dtype}, {W.dtype}, {b.dtype}")
    for t in (codes, rows):
        if t.dtype != torch.float32:
            raise ValueError(f"code and xyz must be float32, got {t.dtype}")
    tensors = (w0, W, b, codes, rows)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("weights, code and xyz must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("weights, code and xyz must be contiguous")
    return lay, codes, rpc, rows, lead


def _check_stream(t, n: int, name: str, dev, dtype=torch.bfloat16) -> None:
    if (t is None or t.dtype != dtype or tuple(t.shape) != (n,)
            or t.device != dev or not t.is_contiguous()):
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        raise ValueError(f"the {kind} kernels need {name}(w0, W), contiguous {dtype} ({n},) "
                         f"on {dev}; got " + ("None" if t is None else
                                              f"{t.dtype} {tuple(t.shape)} on {t.device}"))


def _check_tiles(tiles, dev, compute_dtype, lay) -> None:
    if compute_dtype == torch.bfloat16:
        _check_stream(tiles, lay.value_stages * VALUE_STAGE_BYTES // 2, "pack_value_tiles",
                      dev)
    else:
        _check_stream(tiles, lay.f32_value_floats, "pack_value_tiles_f32", dev, torch.float32)


def _check_jacobian_tiles(tiles, dev, compute_dtype, lay) -> None:
    sfx = "" if compute_dtype == torch.bfloat16 else "_f32"
    if not isinstance(tiles, (tuple, list)) or len(tiles) != 2:
        raise ValueError(f"the Jacobian kernel needs tiles = (pack_value_tiles{sfx}(w0, W), "
                         f"pack_backward_tiles{sfx}(w0, W)); got {type(tiles).__name__}")
    _check_tiles(tiles[0], dev, compute_dtype, lay)
    if compute_dtype == torch.bfloat16:
        _check_stream(tiles[1], lay.backward_bytes // 2, "pack_backward_tiles", dev)
    else:
        _check_stream(tiles[1], lay.f32_backward_floats, "pack_backward_tiles_f32", dev,
                      torch.float32)


_CONFIG_KEYS = ("smem_bytes", "threads", "rows_per_block", "stage", "registers",
                "local_bytes")


def _kernel_config(fn: str) -> dict:
    lib = build.load()
    out = (ctypes.c_int * len(_CONFIG_KEYS))()
    _raise_on(lib, getattr(lib, fn)(out), fn)
    return dict(zip(_CONFIG_KEYS, out))


def _prefix(latent: int) -> str:
    """The C names' prefix of a layout's kernels: mlp_sdf, mlp_sdf256."""
    if latent not in LAYOUTS:
        raise ValueError(f"no kernels for latent {latent}: {LAYOUT_NAMES}")
    return "mlp_sdf" if latent == 64 else f"mlp_sdf{latent}"


def value_kernel_config(latent: int = 64) -> dict:
    """The bf16 value kernel's launch figures, read from the built library."""
    return _kernel_config(f"{_prefix(latent)}_value_tc_config")


def jacobian_kernel_config(latent: int = 64) -> dict:
    """The bf16 Jacobian kernel's launch figures, read from the built library."""
    return _kernel_config(f"{_prefix(latent)}_jacobian_tc_config")


_F32_CONFIG_KEYS = ("smem_bytes", "threads", "rows_per_tile", "cluster", "registers",
                    "local_bytes", "ring_slots", "slot_bytes", "clusters_resident")


def f32_kernel_config(latent: int = 64) -> dict:
    """The f32 kernels' launch figures for each tiling, read from the built
    library: {"value" | "jacobian": [{...} in F32_TILINGS' order]}."""
    lib = build.load()
    n, nt = len(_F32_CONFIG_KEYS), len(F32_TILINGS)
    out = (ctypes.c_int * (2 * nt * n))()
    fn = f"{_prefix(latent)}_f32_config"
    _raise_on(lib, getattr(lib, fn)(out), fn)
    vals = list(out)
    return {kind: [dict(zip(_F32_CONFIG_KEYS, vals[(nt * i + j) * n:(nt * i + j + 1) * n]))
                   for j in range(nt)]
            for i, kind in enumerate(("value", "jacobian"))}


def f32_tiling(kind: str, n: int, latent: int = 64) -> tuple:
    """The tiling (rows of a tile, CTAs of a cluster) the f32 launcher
    takes for n rows of `kind` ("value" or "jacobian")."""
    lib = build.load()
    fn = f"{_prefix(latent)}_f32_tiling"
    i = getattr(lib, fn)(int(kind == "jacobian"), n)
    if i < 0:
        _raise_on(lib, -i, fn)
    return F32_TILINGS[i]


def force_f32_tiling(tiling) -> tuple | None:
    """Makes every later f32 launch, of either layout, take `tiling` (one of
    F32_TILINGS; None
    lets the launcher pick by row count again), for timing each choice.
    Returns the previous setting."""
    if tiling is not None and tuple(tiling) not in F32_TILINGS:
        raise ValueError(f"tiling must be one of {F32_TILINGS} or None; got {tiling}")
    prev = build.load().mlp_sdf_f32_force_tiling(
        -1 if tiling is None else F32_TILINGS.index(tuple(tiling)))
    return None if prev < 0 else F32_TILINGS[prev]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.mlp_sdf_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


# -- plain PyTorch versions ---------------------------------------------------

def _rows_in(codes, rpc, rows, lay):
    """Packed (n, in_pad) input rows [code | xyz | 0]."""
    n = rows.shape[0]
    per_row = codes.repeat_interleave(rpc, dim=0)[:n] if codes.shape[0] > 1 \
        else codes.expand(n, lay.latent)
    pad = torch.zeros(n, lay.in_pad - lay.in_dim, dtype=rows.dtype, device=rows.device)
    return torch.cat([per_row, rows, pad], dim=1)


def rounder(compute_dtype):
    """x -> x rounded to compute_dtype and back to f32 (identity in f32)."""
    if compute_dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).float()
    return lambda t: t


def _plain_forward(wb, x, compute_dtype, keep_pre: bool, matmul=torch.matmul):
    """Forward sweep over packed rows x (n, in_pad) -> (pre-tanh (n,), the 8
    ReLU layers' pre-activations if keep_pre).

    bf16 mode rounds every operand to bf16 before the product and
    multiplies in f32, which is exact: a bf16 product with f32 accumulation.
    matmul(a, b) -> a @ b in f32 computes every product (see
    `sdf_and_input_jacobian_plain`).
    """
    rnd = rounder(compute_dtype)
    lay = layout_of(wb[0])
    w0, W, b = (w.float() for w in wb)
    pres = []
    h = x
    for i in range(N_LAYERS - 1):
        if i == 0:
            pre = matmul(rnd(x), w0) + b[0]
        else:
            if i == 4:
                # latent re-injection: cols split..511 <- the raw input row
                h = torch.cat([h[:, :lay.split], x[:, :lay.in_dim]], dim=1)
            pre = matmul(rnd(h), W[i - 1]) + b[i]
        h = torch.relu(pre)
        if keep_pre:
            pres.append(pre)
    out = matmul(rnd(h), W[N_LAYERS - 2][:, :1]) + b[N_LAYERS - 1, :1]  # layer 8, column 0
    return out[:, 0], pres


def relu_preactivations(wb, code, xyz, compute_dtype=torch.float32, matmul=torch.matmul):
    """The plain version's pre-activations of the 8 ReLU layers, (…, 8, 512)
    with xyz's leading shape; layer 3's padded columns (split..511) are 0.
    matmul as for `sdf_and_input_jacobian_plain`."""
    lay, codes, rpc, rows, lead = _prepare(wb, compute_dtype, code, xyz)
    _, pres = _plain_forward(wb, _rows_in(codes, rpc, rows, lay), compute_dtype, True, matmul)
    return torch.stack(pres, dim=1).reshape(lead + (N_LAYERS - 1, D))


def relu_margin(wb, code, xyz, compute_dtype=torch.float32):
    """Per row, the least |pre-activation| over the 8 ReLU layers' real
    columns.  Where it is within summation rounding of 0, two correct
    implementations that sum in another order may disagree on the ReLU
    mask, and with it on that row's Jacobian: comparisons leave such rows
    out."""
    pre = relu_preactivations(wb, code, xyz, compute_dtype).abs()
    pre[..., 3, layout_of(wb[0]).split:] = float("inf")
    return pre.amin(dim=(-2, -1))


def sdf_value_plain(wb, code, xyz, compute_dtype=torch.float32):
    """Plain version of `sdf_value_fused` (same inputs, same outputs)."""
    lay, codes, rpc, rows, lead = _prepare(wb, compute_dtype, code, xyz)
    pre, _ = _plain_forward(wb, _rows_in(codes, rpc, rows, lay), compute_dtype, False)
    return torch.tanh(pre).reshape(lead)


def sdf_and_input_jacobian_plain(wb, code, xyz, compute_dtype=torch.float32, masks=None,
                                 matmul=torch.matmul):
    """Plain version of `sdf_and_input_jacobian_fused`: one forward sweep,
    then the reverse sweep from g = 1 − sdf² through gWᵀ and the masks.

    masks: optional ReLU masks (…, 8, 512) for the reverse sweep in place
    of the forward's own (pre-activation > 0), as the kernel reports them
    through `masks_out`: a pre-activation within rounding of 0 may take
    the other side in another summation order, and this holds the reverse
    sweep to the kernel's without that tie.  matmul: computes every
    product, (a, b) -> a @ b in f32; a check passes another summation
    order (f64 sums rounded once, or a model of the tensor cores') to see
    what the order alone does."""
    lay, codes, rpc, rows, lead = _prepare(wb, compute_dtype, code, xyz)
    rnd = rounder(compute_dtype)
    x = _rows_in(codes, rpc, rows, lay)
    pre, pres = _plain_forward(wb, x, compute_dtype, True, matmul)
    if masks is None:
        masks = [p > 0.0 for p in pres]
    else:
        masks = list(masks.reshape(-1, N_LAYERS - 1, D).to(rows.device, torch.bool).unbind(1))
    sdf = torch.tanh(pre)
    w0, W, _ = (w.float() for w in wb)
    g = rnd(1.0 - sdf * sdf)[:, None] * W[N_LAYERS - 2][:, 0][None, :]  # layer 8
    extra = None
    for i in range(N_LAYERS - 2, 0, -1):
        g = matmul(rnd(g * masks[i]), W[i - 1].T)
        if i == 4:
            # columns >= split of layer 4's input belong to the raw input
            extra = g[:, lay.split:]
            g = torch.cat([g[:, :lay.split], torch.zeros_like(extra)], dim=1)
    grad = matmul(rnd(g * masks[0]), w0.T)
    grad = grad[:, :lay.in_dim] + extra
    return sdf.reshape(lead), grad.reshape(lead + (lay.in_dim,))


# -- kernel wrappers ----------------------------------------------------------

def _fold_scratch(lay, compute_dtype, n, rpc, dev):
    """The fold kernel's (2, codes, 512) f32 output where the layout folds
    in bf16, else None."""
    if not (lay.fold and compute_dtype == torch.bfloat16):
        return None
    return torch.empty(2, (n + rpc - 1) // rpc, D, dtype=torch.float32, device=dev)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def sdf_value_fused(wb, code, xyz, compute_dtype=torch.float32, tiles=None):
    """Value-only query -> sdf with xyz's leading shape.

    wb: packed (w0, W, b) of a compiled layout with w0 and W in
    compute_dtype (bf16 or f32), b f32.  tiles: the weight stream the kernel
    reads, `pack_value_tiles(w0, W)` in bf16 and `pack_value_tiles_f32(w0,
    W)` in f32 (built once per decoder, see `DeepSDFDecoder.tiles`);
    required on the card, unused by the plain version.
    """
    lay, codes, rpc, rows, lead = _prepare(wb, compute_dtype, code, xyz)
    bf16 = compute_dtype == torch.bfloat16
    if tiles is not None or rows.device.type != "cpu":
        _check_tiles(tiles, rows.device, compute_dtype, lay)
    if rows.device.type == "cpu":
        return sdf_value_plain(wb, code, xyz, compute_dtype)
    lib = build.load()
    n = rows.shape[0]
    sdf = torch.empty(n, dtype=torch.float32, device=rows.device)
    if n:
        w0, W, b = wb
        fold = _fold_scratch(lay, compute_dtype, n, rpc, rows.device)
        err = lib.mlp_sdf_value(lay.latent, codes.data_ptr(), rpc, rows.data_ptr(), n,
                                w0.data_ptr(), W.data_ptr(), b.data_ptr(), int(bf16),
                                tiles.data_ptr(), _ptr(fold), sdf.data_ptr(), _stream())
        _raise_on(lib, err, "mlp_sdf_value")
        LAUNCHES[kernel_name("mlp_sdf_value", compute_dtype)] += 1
        ROWS[kernel_name("mlp_sdf_value", compute_dtype)] += n
    return sdf.reshape(lead)


def sdf_and_input_jacobian_fused(wb, code, xyz, compute_dtype=torch.float32, tiles=None,
                                 masks_out=None):
    """Fused query -> (sdf, d sdf / d[code, xyz] (…, L + 3)) with xyz's
    leading shape.  wb as for `sdf_value_fused`.  tiles: the pair of
    streams the kernel reads its forward and backward weights from,
    (`pack_value_tiles(w0, W)`, `pack_backward_tiles(w0, W)`) in bf16 and
    (`pack_value_tiles_f32(w0, W)`, `pack_backward_tiles_f32(w0, W)`) in
    f32 (see `DeepSDFDecoder.tiles`); required on the card, unused by the
    plain version.  masks_out: optional contiguous uint8
    (…, 8, 512) on the card that the bf16 kernel fills with the ReLU masks
    it took (1 where the pre-activation is > 0), for checking it against
    `sdf_and_input_jacobian_plain(..., masks=)`."""
    lay, codes, rpc, rows, lead = _prepare(wb, compute_dtype, code, xyz)
    bf16 = compute_dtype == torch.bfloat16
    if tiles is not None or rows.device.type != "cpu":
        _check_jacobian_tiles(tiles, rows.device, compute_dtype, lay)
    if masks_out is not None and (
            not bf16 or rows.device.type == "cpu" or masks_out.dtype != torch.uint8
            or tuple(masks_out.shape) != lead + (N_LAYERS - 1, D)
            or masks_out.device != rows.device or not masks_out.is_contiguous()):
        raise ValueError(f"masks_out must be contiguous uint8 {lead + (N_LAYERS - 1, D)} on "
                         "the card, for the bf16 kernel only")
    if rows.device.type == "cpu":
        return sdf_and_input_jacobian_plain(wb, code, xyz, compute_dtype)
    lib = build.load()
    n = rows.shape[0]
    sdf = torch.empty(n, dtype=torch.float32, device=rows.device)
    grad = torch.empty(n, lay.in_dim, dtype=torch.float32, device=rows.device)
    if n:
        w0, W, b = wb
        fwd, bwd = (t.data_ptr() for t in tiles)
        fold = _fold_scratch(lay, compute_dtype, n, rpc, rows.device)
        err = lib.mlp_sdf_jacobian(lay.latent, codes.data_ptr(), rpc, rows.data_ptr(), n,
                                   w0.data_ptr(), W.data_ptr(), b.data_ptr(), int(bf16), fwd,
                                   bwd, _ptr(fold), sdf.data_ptr(), grad.data_ptr(),
                                   _ptr(masks_out), _stream())
        _raise_on(lib, err, "mlp_sdf_jacobian")
        LAUNCHES[kernel_name("mlp_sdf_jacobian", compute_dtype)] += 1
        ROWS[kernel_name("mlp_sdf_jacobian", compute_dtype)] += n
    return sdf.reshape(lead), grad.reshape(lead + (lay.in_dim,))
