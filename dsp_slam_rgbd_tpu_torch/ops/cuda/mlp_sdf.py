"""Fused DeepSDF decoder kernels: value, and value + input Jacobian.

Counterpart of `dsp_slam_rgbd_tpu/ops/pallas/mlp_sdf.py`.  The two Pallas
TPU kernels (`_make_kernel`, `_make_value_kernel`) are CUDA C++ for sm_90a
in `csrc/mlp_sdf.cu`, with the bf16 value pass on the tensor cores in
`csrc/mlp_sdf_value_tc.cu`; this module packs the weights, checks and
flattens the inputs, launches the kernels, and keeps beside each one its
plain PyTorch version (the CPU route and the reference the card is held to).

Packed layout (as on the TPU): w0 (128, 512) for layer 0 over the input
rows [code 64 | xyz 3 | 0]; W (8, 512, 512) for layers 1..8, layer 3's 445
real output columns padded with zeros and layer 8's single output in
column 0; b (9, 512).  Before layer 4 the raw 67-d input is written into
columns 445..511 (the decoder's latent re-injection).

The bf16 value kernel reads w0 and W[0..6] as `pack_value_tiles` lays them
out: the exact shared-memory image of each stage of its weight ring.

Batching: code may be one shared (64,) code, per-row (N, 64) codes, or
per-object (B, 64) codes over xyz (B, N, 3); every form is one launch over
all rows, with row g reading code[g // rows_per_code].

Routing: a CUDA tensor launches the kernel (or raises); a CPU tensor runs
the plain version.  Nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from dsp_slam_rgbd_tpu_torch.ops.cuda import build

D = 512
IN_DIM = 67     # 64 code + 3 xyz
IN_PAD = 128    # packed input width of layer 0
SPLIT = 445     # layer-3 real output width (D − IN_DIM)
N_LAYERS = 9

VALUE_KC = 64                                  # K rows of a layer per value-kernel stage
VALUE_STAGES = (IN_PAD + (N_LAYERS - 2) * D) // VALUE_KC   # 58
VALUE_STAGE_BYTES = VALUE_KC * D * 2           # one stage: 64 K x 512 outputs, bf16

# launches per kernel since the last reset (the plain versions count none)
LAUNCHES = {"mlp_sdf_value": 0, "mlp_sdf_jacobian": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def compatible(spec) -> bool:
    """True when the decoder arch matches the kernels' static layout
    (cars/chairs_64: 64-d latent, 8x512 hidden, latent_in=(4,))."""
    return (
        getattr(spec, "latent_size", None) == 64
        and tuple(getattr(spec, "latent_in", ())) == (4,)
        and getattr(spec, "dims", None) is not None
        and tuple(spec.dims) == (512,) * 8
    )


def pack_params(layers, spec):
    """Pack [(W_i (in, out), b_i (out,))] into f32 (w0 (128, 512),
    W (8, 512, 512), b (9, 512)) on the layers' device.

    Raises ValueError for a decoder whose arch does not fit the layout: it
    would silently zero-pad into it and return wrong SDF values.
    """
    if not compatible(spec) or len(layers) != N_LAYERS:
        raise ValueError(
            "the fused decoder kernels require the cars/chairs_64 layout "
            "(latent 64, 8x512 dims, latent_in=(4,)); got "
            f"latent={getattr(spec, 'latent_size', None)} "
            f"dims={getattr(spec, 'dims', None)} "
            f"latent_in={getattr(spec, 'latent_in', None)}")
    dev = layers[0][0].device
    w0 = torch.zeros(IN_PAD, D, device=dev)
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


def pack_value_tiles(w0, W):
    """bf16 w0 (128, 512) and W[0..6] -> the bf16 value kernel's weight
    stream, flat (VALUE_STAGES * VALUE_STAGE_BYTES / 2,).

    Stage s holds rows 64s..64s+63 of [w0; W[0]; ...; W[6]] (one K chunk of
    one layer), transposed so that each output n is a 128-byte row of its
    64 K values (B K-major), in the 128-byte swizzle: the 16-byte chunk of
    K values 8c..8c+7 of output n sits at chunk position c ^ (n % 8).  Each
    stage is one contiguous copy into shared memory; outputs 0..255 and
    256..511 are its two 32 KB halves.
    """
    if w0.dtype != torch.bfloat16 or W.dtype != torch.bfloat16:
        raise ValueError(f"value tiles are bf16; got {w0.dtype}, {W.dtype}")
    rows = torch.cat([w0, W[:N_LAYERS - 2].reshape(-1, D)])    # (3712, 512) = (K, N)
    t = rows.reshape(VALUE_STAGES, VALUE_KC, D).transpose(1, 2)  # (s, n, k)
    t = t.reshape(VALUE_STAGES, D, VALUE_KC // 8, 8)              # (s, n, chunk, e)
    n = torch.arange(D, device=w0.device)
    chunk = torch.arange(VALUE_KC // 8, device=w0.device)
    src = chunk[None, :] ^ (n % 8)[:, None]     # position p holds chunk p ^ (n % 8)
    t = torch.gather(t, 2, src[None, :, :, None].expand_as(t))
    return t.contiguous().reshape(-1)


# -- input handling -----------------------------------------------------------

def _flatten(code: torch.Tensor, xyz: torch.Tensor):
    """-> (codes (C, 64), rows_per_code, xyz rows (n, 3), leading shape)."""
    lead = tuple(xyz.shape[:-1])
    if xyz.shape[-1] != 3 or xyz.dim() not in (2, 3):
        raise ValueError(f"xyz must be (N, 3) or (B, N, 3), got {tuple(xyz.shape)}")
    rows = xyz.reshape(-1, 3)
    n = rows.shape[0]
    if code.shape[-1] != 64:
        raise ValueError(f"code must have 64 columns, got {tuple(code.shape)}")
    if code.dim() == 1:                                   # shared
        return code.reshape(1, 64), max(n, 1), rows, lead
    if tuple(code.shape[:-1]) == lead:                    # per row
        return code.reshape(-1, 64), 1, rows, lead
    if xyz.dim() == 3 and code.dim() == 2 and code.shape[0] == lead[0]:
        return code, max(lead[1], 1), rows, lead          # per object
    raise ValueError(f"code {tuple(code.shape)} does not match xyz {tuple(xyz.shape)}")


def _check(wb, compute_dtype, codes, rows):
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    w0, W, b = wb
    if (tuple(w0.shape) != (IN_PAD, D) or tuple(W.shape) != (N_LAYERS - 1, D, D)
            or tuple(b.shape) != (N_LAYERS, D)):
        raise ValueError("packed weights must be w0 (128, 512), W (8, 512, 512), "
                         f"b (9, 512); got {tuple(w0.shape)}, {tuple(W.shape)}, "
                         f"{tuple(b.shape)}")
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


def _check_tiles(tiles, dev) -> None:
    n = VALUE_STAGES * VALUE_STAGE_BYTES // 2
    if (tiles is None or tiles.dtype != torch.bfloat16 or tuple(tiles.shape) != (n,)
            or tiles.device != dev or not tiles.is_contiguous()):
        raise ValueError(f"the bf16 value kernel needs tiles = pack_value_tiles(w0, W), "
                         f"contiguous bf16 ({n},) on {dev}; got "
                         + ("None" if tiles is None else
                            f"{tiles.dtype} {tuple(tiles.shape)} on {tiles.device}"))


def value_kernel_config() -> dict:
    """The bf16 value kernel's launch figures, read from the built library."""
    lib = build.load()
    out = (ctypes.c_int * 6)()
    _raise_on(lib, lib.mlp_sdf_value_tc_config(out), "mlp_sdf_value_tc_config")
    keys = ("smem_bytes", "threads", "rows_per_block", "stage", "registers", "local_bytes")
    return dict(zip(keys, out))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.mlp_sdf_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


# -- plain PyTorch versions ---------------------------------------------------

def _rows_in(codes, rpc, rows):
    """Packed (n, 128) input rows [code | xyz | 0]."""
    n = rows.shape[0]
    per_row = codes.repeat_interleave(rpc, dim=0)[:n] if codes.shape[0] > 1 \
        else codes.expand(n, 64)
    pad = torch.zeros(n, IN_PAD - IN_DIM, dtype=rows.dtype, device=rows.device)
    return torch.cat([per_row, rows, pad], dim=1)


def rounder(compute_dtype):
    """x -> x rounded to compute_dtype and back to f32 (identity in f32)."""
    if compute_dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).float()
    return lambda t: t


def _plain_forward(wb, x, compute_dtype, keep_pre: bool):
    """Forward sweep over packed rows x (n, 128) -> (pre-tanh (n,), the 8
    ReLU layers' pre-activations if keep_pre).

    bf16 mode rounds every operand to bf16 before the product and
    multiplies in f32, which is exact: a bf16 product with f32 accumulation.
    """
    rnd = rounder(compute_dtype)
    w0, W, b = (w.float() for w in wb)
    pres = []
    h = x
    for i in range(N_LAYERS - 1):
        if i == 0:
            pre = rnd(x) @ w0 + b[0]
        else:
            if i == 4:
                # latent re-injection: cols 445..511 <- raw input's 67 dims
                h = torch.cat([h[:, :SPLIT], x[:, :IN_DIM]], dim=1)
            pre = rnd(h) @ W[i - 1] + b[i]
        h = torch.relu(pre)
        if keep_pre:
            pres.append(pre)
    out = rnd(h) @ W[N_LAYERS - 2][:, :1] + b[N_LAYERS - 1, :1]  # layer 8, column 0
    return out[:, 0], pres


def relu_margin(wb, code, xyz, compute_dtype=torch.float32):
    """Per row, the least |pre-activation| over the 8 ReLU layers' real
    columns.  Where it is within summation rounding of 0, two correct
    implementations that sum in another order may disagree on the ReLU
    mask, and with it on that row's Jacobian: comparisons leave such rows
    out."""
    codes, rpc, rows, lead = _flatten(code, xyz)
    _check(wb, compute_dtype, codes, rows)
    _, pres = _plain_forward(wb, _rows_in(codes, rpc, rows), compute_dtype, True)
    pres[3] = pres[3][:, :SPLIT]
    margin = torch.stack([p.abs().amin(dim=1) for p in pres]).amin(dim=0)
    return margin.reshape(lead)


def sdf_value_plain(wb, code, xyz, compute_dtype=torch.float32):
    """Plain version of `sdf_value_fused` (same inputs, same outputs)."""
    codes, rpc, rows, lead = _flatten(code, xyz)
    _check(wb, compute_dtype, codes, rows)
    pre, _ = _plain_forward(wb, _rows_in(codes, rpc, rows), compute_dtype, False)
    return torch.tanh(pre).reshape(lead)


def sdf_and_input_jacobian_plain(wb, code, xyz, compute_dtype=torch.float32):
    """Plain version of `sdf_and_input_jacobian_fused`: one forward sweep,
    then the reverse sweep from g = 1 − sdf² through gWᵀ and the masks."""
    codes, rpc, rows, lead = _flatten(code, xyz)
    _check(wb, compute_dtype, codes, rows)
    rnd = rounder(compute_dtype)
    x = _rows_in(codes, rpc, rows)
    pre, pres = _plain_forward(wb, x, compute_dtype, True)
    masks = [p > 0.0 for p in pres]
    sdf = torch.tanh(pre)
    w0, W, _ = (w.float() for w in wb)
    g = rnd(1.0 - sdf * sdf)[:, None] * W[N_LAYERS - 2][:, 0][None, :]  # layer 8
    extra = None
    for i in range(N_LAYERS - 2, 0, -1):
        g = rnd(g * masks[i]) @ W[i - 1].T
        if i == 4:
            # columns >= SPLIT of layer 4's input belong to the raw input
            extra = g[:, SPLIT:]
            g = torch.cat([g[:, :SPLIT], torch.zeros_like(extra)], dim=1)
    grad = rnd(g * masks[0]) @ w0.T
    grad = grad[:, :IN_DIM] + extra
    return sdf.reshape(lead), grad.reshape(lead + (IN_DIM,))


# -- kernel wrappers ----------------------------------------------------------

def sdf_value_fused(wb, code, xyz, compute_dtype=torch.float32, tiles=None):
    """Value-only query -> sdf with xyz's leading shape.

    wb: packed (w0, W, b) with w0 and W in compute_dtype (bf16 = the
    production mode, f32 = parity), b f32.  tiles: `pack_value_tiles(w0,
    W)`, which the bf16 kernel reads its weights from (built once per
    decoder, see `DeepSDFDecoder.value_tiles`); required for bf16 on the
    card, unused in f32 and by the plain version.
    """
    codes, rpc, rows, lead = _flatten(code, xyz)
    _check(wb, compute_dtype, codes, rows)
    bf16 = compute_dtype == torch.bfloat16
    if tiles is not None or (bf16 and rows.device.type != "cpu"):
        _check_tiles(tiles, rows.device)
    if rows.device.type == "cpu":
        return sdf_value_plain(wb, code, xyz, compute_dtype)
    lib = build.load()
    n = rows.shape[0]
    sdf = torch.empty(n, dtype=torch.float32, device=rows.device)
    if n:
        w0, W, b = wb
        err = lib.mlp_sdf_value(codes.data_ptr(), rpc, rows.data_ptr(), n, w0.data_ptr(),
                                W.data_ptr(), b.data_ptr(), int(bf16),
                                tiles.data_ptr() if bf16 else None, sdf.data_ptr(), _stream())
        _raise_on(lib, err, "mlp_sdf_value")
        LAUNCHES["mlp_sdf_value"] += 1
    return sdf.reshape(lead)


def sdf_and_input_jacobian_fused(wb, code, xyz, compute_dtype=torch.float32):
    """Fused query -> (sdf, d sdf / d[code, xyz] (…, 67)) with xyz's
    leading shape.  wb as for `sdf_value_fused`."""
    codes, rpc, rows, lead = _flatten(code, xyz)
    _check(wb, compute_dtype, codes, rows)
    if rows.device.type == "cpu":
        return sdf_and_input_jacobian_plain(wb, code, xyz, compute_dtype)
    lib = build.load()
    n = rows.shape[0]
    sdf = torch.empty(n, dtype=torch.float32, device=rows.device)
    grad = torch.empty(n, IN_DIM, dtype=torch.float32, device=rows.device)
    if n:
        w0, W, b = wb
        err = lib.mlp_sdf_jacobian(codes.data_ptr(), rpc, rows.data_ptr(), n, w0.data_ptr(),
                                   W.data_ptr(), b.data_ptr(),
                                   int(compute_dtype == torch.bfloat16),
                                   sdf.data_ptr(), grad.data_ptr(), _stream())
        _raise_on(lib, err, "mlp_sdf_jacobian")
        LAUNCHES["mlp_sdf_jacobian"] += 1
    return sdf.reshape(lead), grad.reshape(lead + (IN_DIM,))
