"""The f32 decoder kernels' weight streams (`pack_value_tiles_f32`,
`pack_backward_tiles_f32`) and their route.

The f32 kernels (`csrc/mlp_sdf_f32.cu`) read their weights from two flat
f32 buffers through a ring of 8 or 16 KB slots.  A cluster of c = 1 or 2
CTAs shares a tile of rows, CTA `rank` computing output columns
[rank 512/c, (rank+1) 512/c); its producer copies, for each slot, KS =
slot floats / (512 / c) rows of each of its 512/(128 c) column blocks, and
lane l of a consumer warp reads position 4l + j of a block's row as column
l + 32j.  The last
product (g w0ᵀ, 128 outputs) reads whole w0ᵀ blocks in every CTA.  A wrong
offset gives plausible but wrong values on the card, so here the packers
are held, at the full cars_64 width, to an address function written out
independently and to a model of what each CTA's slots hold; the kernels
themselves run only on the card (the `cuda` test below, and
chip_smoke.py's phase 3).  On the CPU the route takes the plain version,
held here to the Pallas kernels in interpret mode (f32: sdf atol 2e-5,
Jacobian atol 2e-4 off ReLU near-tie rows, as in test_torch_mlp_sdf.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.models import deepsdf as jdeepsdf
from dsp_slam_rgbd_tpu.ops.pallas import mlp_sdf as jmlp
from dsp_slam_rgbd_tpu_torch.models import deepsdf as tdeepsdf
from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf

F32 = torch.float32
SDF_ATOL, JAC_ATOL, TIE = 2e-5, 2e-4, 1e-6
K0, FWD_ROWS, BWD_ROWS = 80, 80 + 7 * 512, 7 * 512   # layer-0 rows padded to 80
# (CTAs of a cluster, floats of a slot) as the kernels' tilings take them:
# 16 KB slots only where they hold at most 16 K rows
SLOTS = [(1, 2048), (1, 4096), (2, 2048), (2, 4096)]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def forward_address(layer, k, col):
    """Float index of B[k][col] of layer `layer` (0: w0, 1..7: W[layer-1])
    in the forward stream: 4 blocks of 128 columns, each all 3,664 rows,
    column l + 32 j of a block at position 4 l + j of its row."""
    row = k if layer == 0 else K0 + (layer - 1) * 512 + k
    return ((col // 128) * FWD_ROWS + row) * 128 + 4 * (col % 32) + (col % 128) // 32


def backward_address(layer, k, n):
    """Float index of W[layer][n, k] (layer 0..6; step layer + 1 reduces
    over W[layer]'s output k, its outputs n are W[layer]'s inputs) in the
    backward stream, W[6]ᵀ first; layer = -1 addresses w0[n, k] in the w0ᵀ
    block that follows."""
    lane_pos = 4 * (n % 32) + (n % 128) // 32
    if layer < 0:
        return 4 * BWD_ROWS * 128 + k * 128 + lane_pos
    return ((n // 128) * BWD_ROWS + (6 - layer) * 512 + k) * 128 + lane_pos


def slot_images(stream, rows, c, slot_floats, rank):
    """What CTA `rank` of a c-CTA cluster holds in each slot of a sweep of
    `rows` rows, as its producer copies it: (slots, blocks, KS, 128)."""
    ks, nb = slot_floats * c // 512, 4 // c
    s = stream[:4 * rows * 128].reshape(4, rows // ks, ks, 128)
    return s[rank * nb:(rank + 1) * nb].swapaxes(0, 1)


def read_back(images):
    """The (rows, 128 nb) matrix a CTA's consumers read from its slots
    (slots, nb, KS, 128): lane l of the warp on block wc takes position
    4 l + j as its column 128 wc + l + 32 j."""
    slots, nb, ks, _ = images.shape
    t = images.reshape(slots, nb, ks, 32, 4).swapaxes(3, 4)         # (…, j, l)
    return t.swapaxes(0, 1).reshape(nb, slots * ks, 128).swapaxes(0, 1).reshape(
        slots * ks, nb * 128)


@pytest.fixture(scope="module")
def dec():
    return tdeepsdf.init_decoder(tdeepsdf.DecoderSpec(), seed=0, device="cpu")


def _weights(kind, dec):
    if kind == "decoder":
        w0, W, _ = dec.packed(F32)
        return w0, W
    gen = torch.Generator().manual_seed(3)
    w0 = torch.zeros(128, 512)
    w0[:67] = torch.randn(67, 512, generator=gen)    # rows 67.. are the packed zeros
    return w0, torch.randn(8, 512, 512, generator=gen)


def test_stream_lengths_are_the_slots_bytes(dec):
    fwd = mlp_sdf.pack_value_tiles_f32(*_weights("decoder", dec))
    bwd = mlp_sdf.pack_backward_tiles_f32(*_weights("decoder", dec))
    assert fwd.dtype == F32 and bwd.dtype == F32 and fwd.is_contiguous() and bwd.is_contiguous()
    assert fwd.numel() == mlp_sdf.F32_VALUE_FLOATS == 4 * FWD_ROWS * 128
    assert bwd.numel() == mlp_sdf.F32_BACKWARD_FLOATS == 4 * BWD_ROWS * 128 + 512 * 128
    assert sorted({c for _, c in mlp_sdf.F32_TILINGS}) == sorted({c for c, _ in SLOTS})
    for c, slot in SLOTS:
        ks = slot * c // 512
        # every CTA of the cluster takes FWD_ROWS / ks full slots, c of them a tile
        # every layer's rows are whole slots
        assert K0 % ks == 0 and 512 % ks == 0
        assert c * (FWD_ROWS // ks) * slot == fwd.numel()
        assert c * (BWD_ROWS // ks) * slot + (512 // ks) * ks * 128 == bwd.numel()


@pytest.mark.parametrize("kind", ["decoder", "random"])
@pytest.mark.parametrize("c,slot", SLOTS)
def test_every_cluster_slice_gives_back_the_weights(dec, kind, c, slot):
    """Unpacking every slot of every CTA of the cluster, as the producer
    copies it and the consumers read it, gives back [w0[:80]; W[0..6]]
    (forward) and W[6]ᵀ..W[0]ᵀ, then w0ᵀ (backward), exactly."""
    w0, W = _weights(kind, dec)
    fwd = mlp_sdf.pack_value_tiles_f32(w0, W).numpy()
    bwd = mlp_sdf.pack_backward_tiles_f32(w0, W).numpy()
    want_f = torch.cat([w0[:K0], W[:7].reshape(-1, 512)]).numpy()
    want_b = W[:7].flip(0).transpose(1, 2).reshape(-1, 512).numpy()
    nc = 512 // c
    for rank in range(c):
        cols = slice(rank * nc, (rank + 1) * nc)
        np.testing.assert_array_equal(read_back(slot_images(fwd, FWD_ROWS, c, slot, rank)),
                                      want_f[:, cols])
        np.testing.assert_array_equal(read_back(slot_images(bwd, BWD_ROWS, c, slot, rank)),
                                      want_b[:, cols])
    # the w0ᵀ slots: one whole block of KS rows each, the same in every CTA
    ks = slot * c // 512
    w0t = bwd[4 * BWD_ROWS * 128:].reshape(512 // ks, 1, ks, 128)
    np.testing.assert_array_equal(read_back(w0t), w0.T.numpy())


@pytest.mark.parametrize("layer,k,col", [(0, 0, 0), (0, 0, 1), (0, 66, 511), (0, 79, 200),
                                         (1, 0, 32), (3, 17, 445), (4, 511, 127),
                                         (7, 300, 384), (5, 64, 96)])
def test_forward_address_spot_checks(layer, k, col):
    w0, W = _weights("random", None)
    fwd = mlp_sdf.pack_value_tiles_f32(w0, W)
    want = w0[k, col] if layer == 0 else W[layer - 1, k, col]
    assert fwd[forward_address(layer, k, col)].item() == want.item()


@pytest.mark.parametrize("layer,k,n", [(6, 0, 0), (6, 0, 33), (0, 511, 511), (3, 200, 445),
                                       (-1, 0, 0), (-1, 511, 66), (-1, 100, 127), (2, 5, 130)])
def test_backward_address_spot_checks(layer, k, n):
    w0, W = _weights("random", None)
    bwd = mlp_sdf.pack_backward_tiles_f32(w0, W)
    want = w0[n, k] if layer < 0 else W[layer, n, k]
    assert bwd[backward_address(layer, k, n)].item() == want.item()


@pytest.mark.parametrize("packer", ["pack_value_tiles_f32", "pack_backward_tiles_f32"])
def test_packers_reject_bf16(dec, packer):
    w0, W, _ = dec.packed(torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        getattr(mlp_sdf, packer)(w0, W)


def test_decoder_builds_both_streams_once_and_on_move(dec):
    w0, W, _ = dec.packed(F32)
    np.testing.assert_array_equal(dec.value_tiles_f32.numpy(),
                                  mlp_sdf.pack_value_tiles_f32(w0, W).numpy())
    np.testing.assert_array_equal(dec.backward_tiles_f32.numpy(),
                                  mlp_sdf.pack_backward_tiles_f32(w0, W).numpy())
    fwd, bwd = dec.tiles(F32, jacobian=True)
    assert fwd is dec.value_tiles_f32 and bwd is dec.backward_tiles_f32
    assert dec.tiles(F32) is fwd and dec.tiles(torch.bfloat16) is dec.value_tiles
    assert dec.tiles(torch.bfloat16, jacobian=True) == dec.jacobian_tiles
    dec.query(torch.zeros(64), torch.zeros(5, 3))
    dec.query_with_jacobian(torch.zeros(64), torch.zeros(5, 3))
    assert dec.value_tiles_f32 is fwd and dec.backward_tiles_f32 is bwd   # not rebuilt per query
    moved = tdeepsdf.init_decoder(tdeepsdf.DecoderSpec(), seed=0, device="cpu").float()
    assert moved.value_tiles_f32 is not fwd and moved.backward_tiles_f32 is not bwd
    assert all(t.device == moved.W0.device for t in moved.tiles(F32, jacobian=True))
    np.testing.assert_array_equal(moved.backward_tiles_f32.numpy(), bwd.numpy())


@pytest.mark.parametrize("bad", ["dtype", "length", "noncontiguous", "bf16_stream"])
def test_value_wrapper_rejects_a_bad_stream(dec, bad):
    tiles = {"dtype": dec.value_tiles_f32.double(), "length": dec.value_tiles_f32[:-4],
             "noncontiguous": torch.stack([dec.value_tiles_f32] * 2, 1)[:, 0],
             "bf16_stream": dec.value_tiles}[bad]
    with pytest.raises(ValueError, match="pack_value_tiles_f32"):
        mlp_sdf.sdf_value_fused(dec.packed(F32), torch.zeros(64), torch.zeros(4, 3), F32, tiles)


@pytest.mark.parametrize("bad", ["single", "triple", "dtype", "length", "bf16_pair"])
def test_jacobian_wrapper_rejects_a_bad_stream(dec, bad):
    fwd, bwd = dec.tiles(F32, jacobian=True)
    tiles = {"single": bwd, "triple": (fwd, bwd, bwd), "dtype": (fwd, bwd.double()),
             "length": (fwd, bwd[:-4]), "bf16_pair": dec.jacobian_tiles}[bad]
    with pytest.raises(ValueError, match="pack_"):
        mlp_sdf.sdf_and_input_jacobian_fused(dec.packed(F32), torch.zeros(64),
                                             torch.zeros(4, 3), F32, tiles)


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
def test_f32_query_routes_match_pallas_f32(form):
    """The decoder's f32 routes (with their streams; the plain versions on
    the CPU) against the Pallas kernels in interpret mode, at one row past
    a 64-row tile."""
    spec = jdeepsdf.DecoderSpec()
    rng = np.random.default_rng(13)
    layers = [(rng.standard_normal((i, o)) * np.sqrt(2.0 / i), np.zeros(o))
              for i, o in spec.layer_dims()]
    params = {"layers": [(jnp.asarray(W, jnp.float32), jnp.asarray(b, jnp.float32))
                         for W, b in layers]}
    dec = tdeepsdf.DeepSDFDecoder(tdeepsdf.DecoderSpec(), layers)
    code, xyz = _codes(form, 65, rng)
    tcode, txyz = torch.tensor(code), torch.tensor(xyz)
    v_t = dec.query(tcode, txyz)
    s_t, g_t = dec.query_with_jacobian(tcode, txyz)
    jcode = jnp.asarray(code)
    if form == "per-object":     # the Pallas entry takes shared or per-row codes
        jcode = jnp.repeat(jcode, xyz.shape[1], axis=0)
    wb = jmlp.pack_params(params, spec)
    jxyz = jnp.asarray(xyz.reshape(-1, 3))
    v_j = jmlp.sdf_value_fused(wb, jcode, jxyz, interpret=True)
    s_j, g_j = jmlp.sdf_and_input_jacobian_fused(wb, jcode, jxyz, interpret=True)
    assert v_t.shape == s_t.shape == xyz.shape[:-1] and g_t.shape == xyz.shape[:-1] + (67,)
    np.testing.assert_allclose(v_t.reshape(-1).numpy(), np.asarray(v_j), atol=SDF_ATOL)
    np.testing.assert_allclose(s_t.reshape(-1).numpy(), np.asarray(s_j), atol=SDF_ATOL)
    keep = (mlp_sdf.relu_margin(dec.packed(F32), tcode, txyz) >= TIE).reshape(-1).numpy()
    assert keep.mean() >= 0.9
    np.testing.assert_allclose(g_t.reshape(-1, 67).numpy()[keep], np.asarray(g_j)[keep],
                               atol=JAC_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["shared", "per-row", "per-object"])
def test_f32_kernels_match_plain_on_card_at_every_cluster_size(form):
    """On the card: both f32 kernels against their plain versions at ragged
    row counts, with the tiling the launcher picks and with each tiling
    (rows of a tile, cluster size) forced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dec = tdeepsdf.init_decoder(tdeepsdf.DecoderSpec(), seed=0, device="cuda")
    wb = dec.packed(F32)
    rng = np.random.default_rng(14)
    try:
        for tiling in (None,) + mlp_sdf.F32_TILINGS:
            mlp_sdf.force_f32_tiling(tiling)
            for n in (1, 33, 65, 2049):
                code, xyz = (torch.tensor(a, device="cuda") for a in _codes(form, n, rng))
                v_k = mlp_sdf.sdf_value_fused(wb, code, xyz, F32, dec.tiles(F32))
                s_k, g_k = mlp_sdf.sdf_and_input_jacobian_fused(wb, code, xyz, F32,
                                                                dec.tiles(F32, jacobian=True))
                s_p, g_p = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, F32)
                keep = (mlp_sdf.relu_margin(wb, code, xyz) >= TIE).cpu().numpy()
                torch.cuda.synchronize()
                for s in (v_k, s_k):
                    np.testing.assert_allclose(s.cpu().numpy(), s_p.cpu().numpy(), atol=SDF_ATOL)
                np.testing.assert_allclose(g_k.cpu().numpy()[keep], g_p.cpu().numpy()[keep],
                                           atol=JAC_ATOL)
    finally:
        mlp_sdf.force_f32_tiling(None)
