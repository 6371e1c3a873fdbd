"""Operations and bytes that the port's decoder kernels perform, by layout,
counted from the layout itself (not from `flops.py`'s model count, which
takes the whole input row into layer 0).

The kernels run DeepSDF's 9-layer MLP (8 hidden layers of 512, the input
row [code L | xyz 3] re-injected before layer 4, one output).  Where a
block's row tile cannot hold the whole input row (L = 256: 259 columns
past the shared memory the Jacobian kernel has left), the bf16 kernels
fold the code: a fold kernel before each launch forms, for each code of
the launch, its products with layer 0's and layer 4's code rows (two
L x 512 products), and the rows carry only xyz through layer 0 and the
raw xyz beside layer 3's output into layer 4 (whose K chunks of 64 that
hold only code columns the kernels leave out).  So per row the value
kernel performs

    layer 0 over xyz (3 x 512), layers 1-2 (512 x 512), layer 3
    (512 x (512 - L - 3)), layer 4 over layer 3's output and xyz
    ((512 - L) x 512), layers 5-7 (512 x 512), layer 8 (512 x 1),

and per code of a launch 2 x L x 512; a multiply-add is 2 operations.
The Jacobian kernel adds one reverse sweep, which multiplies the whole
transposed weights, code rows included (its input gradient has L + 3
columns): as many operations as the unfolded forward pass.  Without the
fold (L = 64) a row performs the unfolded forward pass.

Bytes are what a launch must move at least: each row's xyz in (3 float32)
and its outputs (the SDF, and for the Jacobian L + 3 gradients, float32);
once a launch the weight streams the kernel reads (bf16, as packed:
`value_stream_bytes`, `backward_stream_bytes`), the f32 biases, each
code (L float32) and, folded, the code rows of layers 0 and 4 (bf16) and
the fold's per-code results (2 x 512 float32 a code, written and read).
"""
from __future__ import annotations

D = 512
LAYERS = 9
KC = 64          # K rows of a bf16 weight stage


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def folded(latent: int) -> bool:
    """Whether the bf16 kernels fold the code (the row tile would pass two
    64-wide atoms)."""
    return _up(latent + 3, KC) > 2 * KC


def layer_macs(latent: int) -> list[int]:
    """Multiply-adds a row of each layer of the unfolded forward pass."""
    in_dim = latent + 3
    return [in_dim * D, D * D, D * D, D * (D - in_dim), D * D, D * D, D * D, D * D, D]


def row_flops(latent: int, jacobian: bool) -> float:
    """Operations a row of the value (or Jacobian) kernel performs."""
    macs = layer_macs(latent)
    fwd = sum(macs)
    if folded(latent):
        fwd -= 2 * latent * D            # layers 0 and 4: the code's products are per code
    return 2.0 * (fwd + (sum(macs) if jacobian else 0))


def code_flops(latent: int) -> float:
    """Operations of the fold a code of a launch (0 without the fold)."""
    return 2.0 * 2 * latent * D if folded(latent) else 0.0


def value_stream_bytes(latent: int) -> int:
    """The bf16 forward weight stream: layer 0's stages (the row tile's
    depth) and 7 layers of 512 rows, folded less layer 4's K chunks of the
    code alone; 64 K rows x 512 outputs a stage."""
    if folded(latent):
        split = D - latent - 3
        skip = (split + latent) // KC - _up(split, KC) // KC
        return (KC + 7 * D - skip * KC) * D * 2
    return (_up(latent + 3, KC) + 7 * D) * D * 2


def backward_stream_bytes(latent: int) -> int:
    """The bf16 backward stream: W[6]ᵀ..W[0]ᵀ and w0ᵀ over the input row
    padded to 64."""
    return 7 * D * D * 2 + D * _up(latent + 3, KC) * 2


def launch_bytes(latent: int, jacobian: bool) -> float:
    """Bytes a launch moves once, whatever its rows and codes: the weight
    streams, the f32 biases and, folded, layers 0's and 4's code rows."""
    w = value_stream_bytes(latent) + (backward_stream_bytes(latent) if jacobian else 0)
    if folded(latent):
        w += 2 * latent * D * 2
    return float(w + (LAYERS - 1) * D * 4 + 4)


def code_bytes(latent: int) -> int:
    """Bytes a code of a launch moves: the code and, folded, its two rows
    of the fold's results, written and read."""
    return latent * 4 + (2 * D * 4 * 2 if folded(latent) else 0)


def row_bytes(latent: int, jacobian: bool) -> int:
    return 4 * (3 + 1 + (latent + 3 if jacobian else 0))


def work(latent: int, jacobian: bool, rows: int, launches: int, codes: int) -> tuple:
    """(operations, bytes) of `launches` launches over `rows` rows in all and
    `codes` codes in all (a code counted once a launch)."""
    ops = rows * row_flops(latent, jacobian) + codes * code_flops(latent)
    byts = (rows * row_bytes(latent, jacobian) + launches * launch_bytes(latent, jacobian)
            + codes * code_bytes(latent))
    return float(ops), float(byts)
