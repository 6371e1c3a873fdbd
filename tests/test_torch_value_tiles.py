"""The bf16 value kernel's weight stream (`pack_value_tiles`) and its route.

The tensor-core value kernel reads w0 and W[0..6] from one flat bf16
buffer: a sequence of stages, each the shared-memory image of one 64-deep K
chunk of a layer for all 512 outputs, K-major in the 128-byte swizzle.  Its
wgmma descriptors read that order directly, so a wrong byte here gives
plausible but wrong values on the card.  Here the packer is held to an
address function written out independently, at the full cars_64 width;
the kernel itself runs only on the card (the `cuda` test below, and
chip_smoke.py).  On the CPU the route takes the plain version, which is
held to the Pallas value kernel in interpret mode (bf16: sdf atol 1e-2,
see test_torch_mlp_sdf.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.models import deepsdf as jdeepsdf
from dsp_slam_rgbd_tpu.ops.pallas import mlp_sdf as jmlp
from dsp_slam_rgbd_tpu_torch.models import deepsdf as tdeepsdf
from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf

BF = torch.bfloat16
BF16_SDF_ATOL = 1e-2
STAGES, STAGE_BYTES = 58, 64 * 512 * 2   # (128 + 7 * 512) / 64 K chunks of 64 KB


def sw128_offset(n, k):
    """Byte offset of (output n, depth k) in one stage: output n is a
    128-byte row of its 64 bf16 K values; the 16-byte chunk holding K values
    8c..8c+7 sits at chunk position c XOR (n mod 8) of that row (the
    128-byte swizzle).  Works on ints and on numpy integer arrays."""
    return n * 128 + ((k // 8) ^ (n % 8)) * 16 + (k % 8) * 2


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


@pytest.fixture(scope="module")
def dec():
    return tdeepsdf.init_decoder(tdeepsdf.DecoderSpec(), seed=0, device="cpu")


def _weights(kind, dec):
    if kind == "decoder":
        w0, W, _ = dec.packed(BF)
        return w0, W
    gen = torch.Generator().manual_seed(1)
    return (torch.randn(128, 512, generator=gen).to(BF),
            torch.randn(8, 512, 512, generator=gen).to(BF))


def test_stream_length_is_stages_times_stage_bytes(dec):
    tiles = mlp_sdf.pack_value_tiles(*_weights("decoder", dec))
    assert mlp_sdf.VALUE_STAGES == STAGES and mlp_sdf.VALUE_STAGE_BYTES == STAGE_BYTES
    assert tiles.dtype == BF and tiles.is_contiguous()
    assert tiles.numel() * tiles.element_size() == STAGES * STAGE_BYTES


@pytest.mark.parametrize("kind", ["decoder", "random"])
def test_unpacking_every_stage_gives_back_the_weights(dec, kind):
    """Every element of [w0; W[0]; ...; W[6]] read back through the address
    function, exactly, and every byte of the stream is one of them."""
    w0, W = _weights(kind, dec)
    packed = _bits(mlp_sdf.pack_value_tiles(w0, W))
    rows = _bits(torch.cat([w0, W[:7].reshape(-1, 512)]))              # (K 3712, N 512)
    s, n, k = np.meshgrid(np.arange(STAGES), np.arange(512), np.arange(64), indexing="ij")
    addr = s * STAGE_BYTES + sw128_offset(n, k)
    assert np.unique(addr).size == packed.size and addr.max() < packed.size * 2
    got = packed[addr // 2]                                           # (s, n, k)
    want = rows.reshape(STAGES, 64, 512).transpose(0, 2, 1)
    np.testing.assert_array_equal(got, want)
    # W[7] (layer 8) is not in the stream; the kernel reads its column from W
    assert packed.size == (128 + 7 * 512) * 512


@pytest.mark.parametrize("s,n,k", [(0, 0, 0), (0, 1, 0), (1, 7, 63), (2, 9, 17),
                                   (57, 511, 63), (30, 256, 8)])
def test_address_function_spot_checks(dec, s, n, k):
    """Single elements, in plain integers: stage s is K rows 64s..64s+63 of
    the stacked layers (w0 for s < 2, then W[(s - 2) // 8])."""
    w0, W = _weights("random", dec)
    packed = mlp_sdf.pack_value_tiles(w0, W)
    kk = 64 * s + k
    want = w0[kk, n] if kk < 128 else W[(kk - 128) // 512, (kk - 128) % 512, n]
    assert packed[(s * STAGE_BYTES + sw128_offset(n, k)) // 2].item() == want.item()


def test_swizzle_moves_chunks_in_rows_off_a_multiple_of_8(dec):
    """Row n % 8 = 0 is stored in order; the other rows are not."""
    w0, W = _weights("random", dec)
    stage0 = _bits(mlp_sdf.pack_value_tiles(w0, W))[:STAGE_BYTES // 2].reshape(512, 64)
    rows = _bits(w0[:64]).T                                            # (n, k)
    np.testing.assert_array_equal(stage0[0], rows[0])
    assert not np.array_equal(stage0[1], rows[1])
    np.testing.assert_array_equal(stage0[1].reshape(8, 8)[[1, 0, 3, 2, 5, 4, 7, 6]],
                                  rows[1].reshape(8, 8))


def test_packer_rejects_f32(dec):
    w0, W, _ = dec.packed()
    with pytest.raises(ValueError, match="bf16"):
        mlp_sdf.pack_value_tiles(w0, W)


def test_decoder_builds_the_stream_once_and_on_move(dec):
    w0, W, _ = dec.packed(BF)
    np.testing.assert_array_equal(_bits(dec.value_tiles),
                                  _bits(mlp_sdf.pack_value_tiles(w0, W)))
    first = dec.value_tiles
    code = torch.zeros(64)
    xyz = torch.zeros(5, 3)
    dec.query(code, xyz, BF)
    assert dec.value_tiles is first                   # not rebuilt per query
    moved = tdeepsdf.init_decoder(tdeepsdf.DecoderSpec(), seed=0, device="cpu").float()
    assert moved.value_tiles is not None and moved.value_tiles.device == moved.W0.device


@pytest.mark.parametrize("bad", ["dtype", "length", "noncontiguous"])
def test_wrapper_rejects_bad_tiles(dec, bad):
    tiles = dec.value_tiles
    if bad == "dtype":
        tiles = tiles.float()
    elif bad == "length":
        tiles = tiles[:-8]
    else:
        tiles = torch.stack([tiles, tiles], 1)[:, 0]
    with pytest.raises(ValueError, match="pack_value_tiles"):
        mlp_sdf.sdf_value_fused(dec.packed(BF), torch.zeros(64), torch.zeros(4, 3), BF, tiles)


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
def test_bf16_query_route_matches_pallas_bf16(form):
    """The decoder's bf16 value route (with its tiles; the plain version on
    the CPU) against the Pallas value kernel in interpret mode, at one row
    past a 64-row tile."""
    spec = jdeepsdf.DecoderSpec()
    rng = np.random.default_rng(11)
    layers = [(rng.standard_normal((i, o)) * np.sqrt(2.0 / i), np.zeros(o))
              for i, o in spec.layer_dims()]
    params = {"layers": [(jnp.asarray(W, jnp.float32), jnp.asarray(b, jnp.float32))
                         for W, b in layers]}
    dec = tdeepsdf.DeepSDFDecoder(tdeepsdf.DecoderSpec(), layers)
    code, xyz = _codes(form, 65, rng)
    s_t = dec.query(torch.tensor(code), torch.tensor(xyz), BF)
    jcode = jnp.asarray(code)
    if form == "per-object":     # the Pallas entry takes shared or per-row codes
        jcode = jnp.repeat(jcode, xyz.shape[1], axis=0)
    s_j = jmlp.sdf_value_fused(jmlp.pack_params(params, spec), jcode,
                               jnp.asarray(xyz.reshape(-1, 3)), interpret=True,
                               compute_dtype=jnp.bfloat16)
    assert s_t.shape == xyz.shape[:-1]
    np.testing.assert_allclose(s_t.reshape(-1).numpy(), np.asarray(s_j), atol=BF16_SDF_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["shared", "per-row", "per-object"])
def test_bf16_value_kernel_matches_plain_on_card(form):
    """On the card: the tensor-core value kernel against its plain version
    in bf16 at ragged row counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dec = tdeepsdf.init_decoder(tdeepsdf.DecoderSpec(), seed=0, device="cuda")
    wb = dec.packed(BF)
    rng = np.random.default_rng(12)
    for n in (1, 63, 64, 65, 300, 4097):
        code, xyz = (torch.tensor(a, device="cuda") for a in _codes(form, n, rng))
        v_k = mlp_sdf.sdf_value_fused(wb, code, xyz, BF, dec.value_tiles)
        v_p = mlp_sdf.sdf_value_plain(wb, code, xyz, BF)
        torch.cuda.synchronize()
        np.testing.assert_allclose(v_k.cpu().numpy(), v_p.cpu().numpy(), atol=BF16_SDF_ATOL)
