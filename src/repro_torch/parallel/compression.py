"""Cross-pod gradient compression with error feedback: the port of
``repro.parallel.compression``.

Gradients are reduced hierarchically: in full precision within a pod,
then as an int8 all-reduce across pods, with per-block absmax scales
and error feedback so the quantisation bias does not accumulate over
steps (1-bit-Adam / PowerSGD-style residual correction).

The reference's ``compressed_psum`` runs inside ``shard_map`` over the
'pod' mesh axis, one call per pod.  The port's takes the form of PR
21's mesh, one controller over every pod: the list of the pods'
contributions and residuals, summed as ``psum`` sums them.  The
'pod' axis of a train step comes with ``parallel/sharding.py``
(ROADMAP queue 1 item 2(f)).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

QBLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise absmax int8 quantisation.  Returns (q (nblocks,
    QBLOCK) int8, float32 scales (nblocks,))."""
    flat = x.reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % QBLOCK)).view(-1, QBLOCK)
    amax = blocks.abs().amax(dim=1)   # 127 on the device: a true quotient
    scale = (amax / amax.new_full((), 127.0)).clamp_min(1e-12)
    q = torch.round(blocks / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: Sequence[int]) -> torch.Tensor:
    x = q.float() * scale[:, None]
    n = 1
    for s in shape:
        n *= s
    return x.reshape(-1)[:n].reshape(tuple(shape))


def compressed_psum(xs: Sequence[torch.Tensor],
                    errors: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Quantised all-reduce of the pods' contributions with error
    feedback.

    xs     : each pod's local float32 contribution
    errors : each pod's residual from previous steps (same shape)

    Returns (the reduced float32 mean, each pod's new residual).  The
    int8 payloads are summed in int32 (exact), the scales summed in pod
    order and averaged, and the sum rebuilt with the mean scale and
    divided by the pod count, as the reference's ``psum`` does."""
    n = len(xs)
    qsum, ssum, new_errors = None, None, []
    for x, e in zip(xs, errors):
        corrected = x.float() + e
        q, scale = quantize_int8(corrected)
        new_errors.append(corrected - dequantize_int8(q, scale,
                                                      corrected.shape))
        q = q.to(torch.int32)
        qsum = q if qsum is None else qsum + q
        ssum = scale if ssum is None else ssum + scale
    shape = xs[0].shape
    blocks = qsum.float() * (ssum / n)[:, None]
    reduced = blocks.reshape(-1)[:xs[0].numel()].reshape(shape) / n
    return reduced, new_errors


def compression_ratio(shape) -> float:
    """Wire bytes ratio vs fp32 all-reduce (excluding scale overhead
    amortisation): 1 byte payload + 4/256 bytes scale per element."""
    return (1.0 + 4.0 / QBLOCK) / 4.0
