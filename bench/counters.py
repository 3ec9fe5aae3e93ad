"""The yardstick's arithmetic: the card's peaks, a training step's counted
operations and the embedding kernels' least bytes. Frozen here so that no
change to the port moves what its numbers are divided by.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit (the
same figures as the port's ``utils/roofline.py``).

Operations of one training step (the model FLOP count of an MFU: no
recomputation counted): 6 per matmul parameter and per row it multiplies
(the forward product and the backward's two), plus 3 times attention's
forward pair products, QK^T and P.V over every (query, key) pair of a
sequence, 2 operations a multiply-add. Matmul parameters:

``lstm``   a layer 4 d_ff (d_in + proj) + d_ff proj (the gate products of
           the input and of the projected state, then the projection),
           plus the head's vocab x d;
``dense``  a layer 2 d H hd (q, o) + 2 d KV hd (k, v) + 3 d d_ff (SwiGLU),
           plus the head's vocab x d.

The embedding lookup multiplies nothing and counts no operation.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def matmul_params(cfg: dict) -> int:
    """Parameters that multiply every token's row in a training step."""
    d, f, n, v = cfg["d_model"], cfg["d_ff"], cfg["n_layers"], \
        cfg["vocab_size"]
    if cfg["family"] == "lstm":
        per = 4 * f * (d + d) + f * d
    elif cfg["family"] == "dense":
        hd = cfg["head_dim"]
        per = 2 * d * cfg["n_heads"] * hd + 2 * d * cfg["n_kv_heads"] * hd \
            + 3 * d * f
    else:
        raise ValueError(f"no operation count for family {cfg['family']!r}")
    return n * per + v * d


def attention_flops(cfg: dict, batch: int, seq: int) -> int:
    """A training step's attention pair products: 3 x (QK^T and P.V, 2 x
    head_dim operations each, over seq x seq pairs of every head)."""
    if cfg["family"] != "dense":
        return 0
    fwd = 4 * cfg["head_dim"] * seq * seq * cfg["n_heads"] * batch
    return 3 * cfg["n_layers"] * fwd


def train_step_flops(cfg: dict, batch: int, seq: int) -> int:
    """Counted operations of one training step over ``batch`` rows of
    ``seq`` tokens (one rank's share on a mesh)."""
    return 6 * matmul_params(cfg) * batch * seq \
        + attention_flops(cfg, batch, seq)


def gather_bytes(capacity: int, unique: int, row_bytes: int) -> int:
    """Least bytes of one ``embed_gather`` launch of the deduped buffer:
    its ``capacity`` int32 ids read, the ``min(unique, capacity)`` rows they
    name read once, and ``capacity`` rows written (the slots past the
    unique ids are written as zeros)."""
    return 4 * capacity + row_bytes * min(unique, capacity) \
        + row_bytes * capacity


def scatter_bytes(capacity: int, unique: int, row_bytes: int,
                  table_rows: int, width: int) -> int:
    """Least bytes of one ``embed_scatter_add`` launch: the ``capacity``
    int32 ids read, the owned ids' rows read (``row_bytes`` each, the wire
    dtype), and the (table_rows, width) f32 gradient written once."""
    return 4 * capacity + row_bytes * min(unique, capacity) \
        + 4 * table_rows * width


def least_seconds(nbytes: float) -> float:
    """The least time to move ``nbytes`` at the HBM peak."""
    return nbytes / PEAK_HBM_BYTES_PER_S
