"""The bf16 Jacobian kernel's backward weight stream (`pack_backward_tiles`)
and its route.

The tensor-core Jacobian kernel reads its forward weights from
`pack_value_tiles` and its backward weights (W[6]ᵀ..W[0]ᵀ, then w0ᵀ) from
one more flat bf16 buffer: stages that are the shared-memory image of one
64-deep K chunk of a transposed layer for all its outputs, K-major in the
128-byte swizzle.  Its wgmma descriptors read that order directly, so a
wrong byte here gives plausible but wrong values on the card.  Here the
packer is held to an address function written out independently, at the
full cars_64 width; the kernel itself runs only on the card (the `cuda`
test below, and chip_smoke.py).  On the CPU the route takes the plain
version, which is held to the Pallas Jacobian kernel in interpret mode
(bf16: sdf atol 1e-2, Jacobian Frobenius relative 2e-2, as in
test_torch_mlp_sdf.py) with the trained fixture decoder: at random
zero-bias weights a few ReLU pre-activations per 65 rows lie within the
two f32 summation orders' rounding of 0 and take the other side, which
alone moves the Jacobian by up to 2.2% (measured on this comparison).

That effect sets the terms of the kernel's check on the card, and a model
of the tensor cores' accumulation shows it here: with every product
summed as wgmma sums it, the bf16 Jacobian moves from the plain version's
by 1-2.5% at random weights, only through units whose |pre| lies within
BF16_TIE of 0.  The card's check (chip_smoke.py, and the `cuda` tests
here and in test_torch_mlp_sdf.py) holds the kernel to these bounds.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.models import deepsdf as jdeepsdf
from dsp_slam_rgbd_tpu.ops.pallas import mlp_sdf as jmlp
from dsp_slam_rgbd_tpu_torch.models import deepsdf as tdeepsdf
from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf

BF = torch.bfloat16
BF16_SDF_ATOL, BF16_JAC_FROB = 1e-2, 2e-2
# bf16 Jacobian kernel vs plain (chip_smoke.py's): ReLU masks equal where |pre| >= BF16_TIE
BF16_TIE = 1e-2
W_STAGES, STAGE_BYTES = 56, 64 * 512 * 2       # W[6]ᵀ..W[0]ᵀ: 7 layers x 8 K chunks
W0T_STAGES, W0T_STAGE_BYTES = 8, 64 * 128 * 2  # w0ᵀ: 8 K chunks of 128 outputs
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ellipsoid_decoder_64.npz")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def sw128_offset(n, k):
    """Byte offset of (output n, depth k) in one stage: output n is a
    128-byte row of its 64 bf16 K values; the 16-byte chunk holding K values
    8c..8c+7 sits at chunk position c XOR (n mod 8) of that row (the
    128-byte swizzle).  Works on ints and on numpy integer arrays."""
    return n * 128 + ((k // 8) ^ (n % 8)) * 16 + (k % 8) * 2


def backward_address(layer, chunk, n, k):
    """Byte address of W[layer][n, 64 chunk + k] (layer 0..6) in the stream:
    step i = layer + 1 of the reverse sweep reduces over W[layer]'s output
    index, so its outputs n are W[layer]'s input rows; W[6]'s stages come
    first.  layer = -1 addresses w0[n, 64 chunk + k] in the w0ᵀ stages."""
    if layer < 0:
        return W_STAGES * STAGE_BYTES + chunk * W0T_STAGE_BYTES + sw128_offset(n, k)
    return (8 * (6 - layer) + chunk) * STAGE_BYTES + sw128_offset(n, k)


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


@pytest.fixture(scope="module")
def dec():
    return tdeepsdf.init_decoder(tdeepsdf.DecoderSpec(), seed=0, device="cpu")


def _weights(kind, dec):
    if kind == "decoder":
        w0, W, _ = dec.packed(BF)
        return w0, W
    gen = torch.Generator().manual_seed(2)
    return (torch.randn(128, 512, generator=gen).to(BF),
            torch.randn(8, 512, 512, generator=gen).to(BF))


def test_stream_length_is_the_stages_bytes(dec):
    tiles = mlp_sdf.pack_backward_tiles(*_weights("decoder", dec))
    assert mlp_sdf.BACKWARD_STAGES == W_STAGES and mlp_sdf.W0T_STAGES == W0T_STAGES
    assert tiles.dtype == BF and tiles.is_contiguous()
    assert tiles.numel() * tiles.element_size() == mlp_sdf.BACKWARD_BYTES == \
        W_STAGES * STAGE_BYTES + W0T_STAGES * W0T_STAGE_BYTES


@pytest.mark.parametrize("kind", ["decoder", "random"])
def test_unpacking_every_stage_gives_back_the_weights(dec, kind):
    """Every element of W[0..6] and w0 read back through the address
    function, exactly, and every byte of the stream is one of them."""
    w0, W = _weights(kind, dec)
    packed = _bits(mlp_sdf.pack_backward_tiles(w0, W))
    addrs = []
    for layer in range(7):
        c, n, k = np.meshgrid(np.arange(8), np.arange(512), np.arange(64), indexing="ij")
        addr = backward_address(layer, c, n, k)
        got = packed[addr // 2]                                     # (chunk, n, k)
        want = _bits(W[layer]).reshape(512, 8, 64).transpose(1, 0, 2)
        np.testing.assert_array_equal(got, want)
        addrs.append(addr.ravel())
    c, n, k = np.meshgrid(np.arange(8), np.arange(128), np.arange(64), indexing="ij")
    addr = backward_address(-1, c, n, k)
    np.testing.assert_array_equal(packed[addr // 2],
                                  _bits(w0).reshape(128, 8, 64).transpose(1, 0, 2))
    addrs.append(addr.ravel())
    addrs = np.concatenate(addrs)
    assert np.unique(addrs).size == packed.size and addrs.max() < packed.size * 2
    # W[7] (layer 8) is not in the stream; the kernel reads its column from W
    assert packed.size == (7 * 512 + 128) * 512


@pytest.mark.parametrize("layer,chunk,n,k", [(6, 0, 0, 0), (6, 0, 1, 0), (5, 3, 9, 17),
                                             (0, 7, 511, 63), (3, 2, 256, 8), (-1, 0, 0, 0),
                                             (-1, 7, 127, 63), (-1, 4, 66, 33)])
def test_address_function_spot_checks(dec, layer, chunk, n, k):
    """Single elements, in plain integers."""
    w0, W = _weights("random", dec)
    packed = mlp_sdf.pack_backward_tiles(w0, W)
    want = w0[n, 64 * chunk + k] if layer < 0 else W[layer, n, 64 * chunk + k]
    assert packed[backward_address(layer, chunk, n, k) // 2].item() == want.item()


def test_packer_rejects_f32(dec):
    w0, W, _ = dec.packed()
    with pytest.raises(ValueError, match="bf16"):
        mlp_sdf.pack_backward_tiles(w0, W)


def test_decoder_builds_both_streams_once_and_on_move(dec):
    w0, W, _ = dec.packed(BF)
    np.testing.assert_array_equal(_bits(dec.backward_tiles),
                                  _bits(mlp_sdf.pack_backward_tiles(w0, W)))
    fwd, bwd = dec.jacobian_tiles
    assert fwd is dec.value_tiles and bwd is dec.backward_tiles
    dec.query_with_jacobian(torch.zeros(64), torch.zeros(5, 3), BF)
    assert dec.backward_tiles is bwd                     # not rebuilt per query
    moved = tdeepsdf.init_decoder(tdeepsdf.DecoderSpec(), seed=0, device="cpu").float()
    assert moved.backward_tiles is not None and moved.backward_tiles is not bwd
    assert all(t.device == moved.W0.device for t in moved.jacobian_tiles)
    np.testing.assert_array_equal(_bits(moved.backward_tiles), _bits(bwd))


@pytest.mark.parametrize("bad", ["missing", "single", "triple", "dtype", "length",
                                 "noncontiguous"])
def test_wrapper_rejects_bad_streams(dec, bad):
    fwd, bwd = dec.jacobian_tiles
    tiles = {"missing": (fwd, None), "single": bwd, "dtype": (fwd, bwd.float()),
             "length": (fwd, bwd[:-8]),
             "noncontiguous": (fwd, torch.stack([bwd, bwd], 1)[:, 0]),
             "triple": (fwd, bwd, bwd)}[bad]
    with pytest.raises(ValueError, match="pack_"):
        mlp_sdf.sdf_and_input_jacobian_fused(dec.packed(BF), torch.zeros(64), torch.zeros(4, 3),
                                             BF, tiles)


def test_masks_out_is_for_the_bf16_kernel_only(dec):
    with pytest.raises(ValueError, match="masks_out"):
        mlp_sdf.sdf_and_input_jacobian_fused(dec.packed(BF), torch.zeros(64), torch.zeros(4, 3),
                                             BF, dec.jacobian_tiles,
                                             masks_out=torch.zeros(4, 8, 512, dtype=torch.uint8))


def test_plain_reverse_sweep_takes_given_masks(dec):
    """With its own masks passed in, the plain version is unchanged; with
    one unit flipped per row, the Jacobian moves (what the check on the card
    relies on to see a wrong mask)."""
    rng = np.random.default_rng(5)
    code = torch.tensor(rng.standard_normal(64) * 0.2, dtype=torch.float32)
    xyz = torch.tensor(rng.standard_normal((33, 3)) * 0.5, dtype=torch.float32)
    wb = dec.packed(BF)
    pre = mlp_sdf.relu_preactivations(wb, code, xyz, BF)
    assert pre.shape == (33, 8, 512) and float(pre[:, 3, 445:].abs().max()) == 0.0
    _, g = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, BF)
    _, g_same = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, BF,
                                                     masks=(pre > 0).to(torch.uint8))
    np.testing.assert_array_equal(g_same.numpy(), g.numpy())
    flipped = pre > 0
    flipped[:, 5, 7] ^= True
    _, g_flip = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, BF, masks=flipped)
    assert float(torch.linalg.vector_norm(g_flip - g) / torch.linalg.vector_norm(g)) > 1e-2


def _codes(form, n, rng):
    """(code, xyz) for a shared, per-row or per-object code over n rows."""
    if form == "per-object":
        b = next(d for d in (5, 4, 3, 2, 1) if n % d == 0)
        xyz = rng.standard_normal((b, n // b, 3)) * 0.5
        code = rng.standard_normal((b, 64)) * 0.2
    else:
        xyz = rng.standard_normal((n, 3)) * 0.5
        code = rng.standard_normal((n, 64) if form == "per-row" else 64) * 0.2
    return code.astype(np.float32), xyz.astype(np.float32)


@pytest.mark.parametrize("form", ["shared", "per-row", "per-object"])
def test_bf16_jacobian_route_matches_pallas_bf16(form):
    """The decoder's bf16 Jacobian route (with its streams; the plain
    version on the CPU) against the Pallas Jacobian kernel in interpret
    mode, at one row past a 64-row tile."""
    spec = jdeepsdf.DecoderSpec()
    with np.load(FIXTURE) as z:
        layers = [(z[f"W{i}"].astype(np.float32), z[f"b{i}"].astype(np.float32))
                  for i in range(len(spec.layer_dims()))]
    params = {"layers": [(jnp.asarray(W), jnp.asarray(b)) for W, b in layers]}
    dec = tdeepsdf.DeepSDFDecoder(tdeepsdf.DecoderSpec(), layers)
    code, xyz = _codes(form, 65, np.random.default_rng(11))
    s_t, g_t = dec.query_with_jacobian(torch.tensor(code), torch.tensor(xyz), BF)
    jcode = jnp.asarray(code)
    if form == "per-object":     # the Pallas entry takes shared or per-row codes
        jcode = jnp.repeat(jcode, xyz.shape[1], axis=0)
    s_j, g_j = jmlp.sdf_and_input_jacobian_fused(jmlp.pack_params(params, spec), jcode,
                                                 jnp.asarray(xyz.reshape(-1, 3)), interpret=True,
                                                 compute_dtype=jnp.bfloat16)
    assert s_t.shape == xyz.shape[:-1] and g_t.shape == xyz.shape[:-1] + (67,)
    np.testing.assert_allclose(s_t.reshape(-1).numpy(), np.asarray(s_j), atol=BF16_SDF_ATOL)
    g_t, g_j = g_t.reshape(-1, 67).numpy(), np.asarray(g_j)
    assert np.linalg.norm(g_t - g_j) / np.linalg.norm(g_j) <= BF16_JAC_FROB


def tensor_core_matmul(a, b):
    """a @ b as a model of Hopper's wgmma sums bf16 operands into an f32
    accumulator: each 16-deep group of products exactly, then added to the
    accumulator and truncated toward 0."""
    a, b = a.double(), b.double()
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
    for k in range(0, a.shape[1], 16):
        x = acc + a[:, k:k + 16] @ b[k:k + 16]
        f = x.float()
        f = torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
        acc = f.double()
    return acc.float()


def bf16_tie_check(pre, masks, g, g_masks, g_own):
    """The bf16 Jacobian check's numbers, over rows (pre, masks: (n, 8,
    512); Jacobians: (n, 67)): a Jacobian g taken with ReLU masks `masks`
    against the plain version's pre-activations `pre`, the plain reverse
    sweep under `masks` (g_masks), and the plain version with its own masks
    (g_own), over all rows and over the rows where no mask differs."""
    differ = masks.bool() != (pre > 0)
    agree = ~differ.flatten(1).any(1)
    return {"off_tie": int((differ & (pre.abs() >= BF16_TIE)).sum()),
            "differ": int(differ.sum()), "rows": pre.shape[0],
            "err_masks": _frob(g, g_masks), "err_own": _frob(g, g_own),
            "err_own_agreeing": _frob(g[agree], g_own[agree]) if bool(agree.any()) else 0.0}


def _frob(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def assert_bf16_tie_check(c):
    assert c["off_tie"] == 0, c
    assert c["differ"] <= 8 + c["rows"] // 5, c
    assert c["err_masks"] <= BF16_JAC_FROB and c["err_own_agreeing"] <= BF16_JAC_FROB, c


@pytest.mark.parametrize("form", ["shared", "per-row"])
def test_summation_order_alone_flips_ties(dec, form):
    """The bf16 route with every product summed as the tensor cores sum it
    (a model, `tensor_core_matmul`), at random weights, against the plain
    version: the ReLU masks differ only at ties, and those flips alone move
    the Jacobian by over 0.5% (Frobenius), while under the same masks, or
    on the rows where no mask differs, the two agree within 0.5%: the
    terms of the kernel's check on the card."""
    rng = np.random.default_rng(21)
    code, xyz = (torch.tensor(a) for a in _codes(form, 300, rng))
    wb = dec.packed(BF)
    pre = mlp_sdf.relu_preactivations(wb, code, xyz, BF)
    pre_tc = mlp_sdf.relu_preactivations(wb, code, xyz, BF, tensor_core_matmul)
    _, g_tc = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, BF, matmul=tensor_core_matmul)
    _, g_masks = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, BF, masks=pre_tc > 0)
    _, g_own = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, BF)
    c = bf16_tie_check(pre, pre_tc > 0, g_tc, g_masks, g_own)
    assert_bf16_tie_check(c)
    assert c["differ"] > 0 and c["err_own"] > 5e-3, c
    assert c["err_masks"] < 5e-3 and c["err_own_agreeing"] < 5e-3, c


def test_tie_check_catches_a_wrong_mask(dec):
    """A mask bit wrong at a unit away from the ties fails the check."""
    rng = np.random.default_rng(22)
    code, xyz = (torch.tensor(a) for a in _codes("shared", 40, rng))
    wb = dec.packed(BF)
    pre = mlp_sdf.relu_preactivations(wb, code, xyz, BF)
    r, layer, unit = (int(i[0]) for i in torch.nonzero(pre.abs() > 0.1, as_tuple=True))
    masks = pre > 0
    masks[r, layer, unit] ^= True
    _, g = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, BF, masks=masks)
    _, g_own = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, BF)
    c = bf16_tie_check(pre, masks, g, g, g_own)
    assert c["off_tie"] == 1
    with pytest.raises(AssertionError):
        assert_bf16_tie_check(c)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["shared", "per-row", "per-object"])
def test_bf16_jacobian_kernel_matches_plain_on_card(form):
    """On the card: the tensor-core Jacobian kernel against its plain
    version in bf16 around its 64-row tile and past the 2,048-row launch,
    for each code form (test_torch_mlp_sdf.py's card test takes 300 per-row
    rows): the check above on the masks the kernel reports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dec = tdeepsdf.init_decoder(tdeepsdf.DecoderSpec(), seed=0, device="cuda")
    wb = dec.packed(BF)
    rng = np.random.default_rng(12)
    for n in (1, 63, 64, 65, 2049):
        code, xyz = (torch.tensor(a, device="cuda") for a in _codes(form, n, rng))
        relu = torch.empty(xyz.shape[:-1] + (8, 512), dtype=torch.uint8, device="cuda")
        s_k, g_k = mlp_sdf.sdf_and_input_jacobian_fused(wb, code, xyz, BF, dec.jacobian_tiles,
                                                        masks_out=relu)
        s_p, g_own = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, BF)
        _, g_masks = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, BF, masks=relu)
        pre = mlp_sdf.relu_preactivations(wb, code, xyz, BF).reshape(-1, 8, 512)
        torch.cuda.synchronize()
        np.testing.assert_allclose(s_k.cpu().numpy(), s_p.cpu().numpy(), atol=BF16_SDF_ATOL)
        assert_bf16_tie_check(bf16_tie_check(pre, relu.reshape(-1, 8, 512), g_k.reshape(-1, 67),
                                             g_masks.reshape(-1, 67), g_own.reshape(-1, 67)))
