"""Plain PyTorch versions of the fused agg+opt kernels.

They repeat the kernels' arithmetic operation for operation: f32 compute,
the worker sum taken in worker order and then divided by W, each product
and sum rounded on its own (no FMA), and the results cast back to each
input's dtype.  CPU tensors take these in ``ops.py``; on the card they are
what the CUDA kernels are held against, bitwise.  Every division is a
tensor/tensor division: PyTorch's CUDA division by a Python number
multiplies by its reciprocal.  The rules' constants are Python floats that
PyTorch rounds to f32 once, as the wrappers round them for the kernels;
``1 - b`` is formed in Python (double), never in f32.  Square roots go
through ``sqrt_rn``: PyTorch's vectorised CPU square root (AVX-512) is one
ulp off the IEEE root on some inputs.

Each rule takes ``g`` pre-aggregated (same shape as ``p``, in ``p``'s
dtype or f32) or stacked ``(W, *p.shape)``; the stacked form is averaged
with ``worker_mean`` first, divided by W or by ``divisor``, a one-element
f32 tensor (the live count of an elastic or sanity-gated step).  A
stacked ``g`` may be a view whose rows lie any distance apart (the row
stride the kernels take, ``g.stride(0)``): row w is read as ``g[w]``, so
the same values give the same bits whatever the stride.
``dequant_agg_opt_ref``, the int8 wire's tail, takes the owner's own rows
contiguous, as the block diagonal of the stacked buffer
(``block_diagonal``) or as a window's runs, and a divisor too.  They are
functional: the slots they are given are not written.
Nesterov, Adam and the int8 tail take ``weight_decay`` (the reference's
``ShardedOptimizer._decayed``): ``g + wd * p`` on the f32 gradient, after
the worker mean (or the decode, the owner's add and the scale) and before
the rule, as two rounded operations, the product and then the sum; at 0 the
term is left out (``0 * inf`` would be NaN), so the rules keep the bits
they had without it.
``health_chunks_ref`` is the health kernel's sum of squares per chunk,
added in the kernel's order step by step; ``health_scan_ref`` the
reference's oracle, one ``torch.sum``.
"""
from __future__ import annotations

import torch


def worker_mean(g: torch.Tensor, divisor: torch.Tensor | None = None
                ) -> torch.Tensor:
    """(W, ...) -> f32 mean over dim 0: summed in worker order, then
    divided by W, or by ``divisor`` (not multiplied by the reciprocal: for
    W=3 those differ).  The divisor is a tensor on the same device:
    PyTorch's CUDA division by a Python number multiplies by its
    reciprocal."""
    acc = g[0].float()
    for w in range(1, g.shape[0]):
        acc = acc + g[w].float()
    if divisor is None:
        divisor = acc.new_tensor(float(g.shape[0]))
    return acc / divisor


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The IEEE (correctly rounded) f32 square root of ``x``, returned in
    ``x``'s dtype (a bf16 input is rounded from the f32 root, as XLA does):
    the f64 root rounded once to f32 is the f32 root, on either device."""
    return torch.sqrt(x.double()).float().to(x.dtype)


def _grad32(p: torch.Tensor, g: torch.Tensor,
            divisor: torch.Tensor | None = None) -> torch.Tensor:
    return worker_mean(g, divisor) if g.dim() == p.dim() + 1 else g.float()


def decayed(g32: torch.Tensor, p: torch.Tensor,
            weight_decay: float) -> torch.Tensor:
    """``g32 + wd * p`` in f32 (p cast up), or ``g32`` itself at 0."""
    if not weight_decay:
        return g32
    return g32 + weight_decay * p.float()


def _nesterov(p, g32, m, lr, momentum, weight_decay=0.0):
    g32 = decayed(g32, p, weight_decay)
    m2 = momentum * m.float() + g32
    p2 = p.float() - lr * (g32 + momentum * m2)
    return p2.to(p.dtype), m2.to(m.dtype)


def agg_opt_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, *,
                lr: float, momentum: float, weight_decay: float = 0.0):
    """Nesterov update of p/m by the pre-aggregated gradient g (same
    shape).  Returns (p', m')."""
    return _nesterov(p, g.float(), m, lr, momentum, weight_decay)


def multi_agg_opt_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, *,
                      lr: float, momentum: float,
                      divisor: torch.Tensor | None = None,
                      weight_decay: float = 0.0):
    """Tall aggregation: g is (W, *p.shape) worker gradients, averaged over
    dim 0, then the same update.  Returns (p', m')."""
    return _nesterov(p, worker_mean(g, divisor), m, lr, momentum,
                     weight_decay)


def sgd_opt_ref(p: torch.Tensor, g: torch.Tensor, *, lr: float,
                divisor: torch.Tensor | None = None):
    """``sgd_opt_chunks``' body: p' = p - lr * g in f32.  Returns p'."""
    return (p.float() - lr * _grad32(p, g, divisor)).to(p.dtype)


def adam_opt_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor, *,
                 lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, divisor: torch.Tensor | None = None,
                 weight_decay: float = 0.0):
    """``adam_opt_chunks``' body: the textbook EMAs ``b*m + (1-b)*g``, the
    k1/k2 bias-correction tick gated to positions that have seen gradient
    (``alive``, taken on the aggregated g), the epsilon-hat step
    ``((lr*(1/k1'))*sqrt(k2')*m') / (sqrt(v') + eps*sqrt(k2'))`` and its
    mask to +0 where ``k1' == 0``; ``weight_decay`` enters before all of
    them, ``alive`` included.  Returns (p', m', v', k1', k2')."""
    g32 = decayed(_grad32(p, g, divisor), p, weight_decay)
    c1, c2 = 1 - b1, 1 - b2
    m32, v32, k1f, k2f = m.float(), v.float(), k1.float(), k2.float()
    alive = (g32 != 0) | (k1f != 0)
    k1n = torch.where(alive, b1 * k1f + c1, k1f)
    k2n = torch.where(alive, b2 * k2f + c2, k2f)
    m2 = b1 * m32 + c1 * g32
    v2 = b2 * v32 + c2 * g32 * g32
    rk2 = sqrt_rn(k2n)
    num = lr * (k1n.new_tensor(1.0) / k1n) * rk2 * m2
    step = num / (sqrt_rn(v2) + eps * rk2)
    step = torch.where(k1n > 0, step, torch.zeros_like(step))
    return ((p.float() - step).to(p.dtype), m2.to(m.dtype), v2.to(v.dtype),
            k1n.to(k1.dtype), k2n.to(k2.dtype))


def own_strips(g: torch.Tensor, windows: int = 1, w: int = 0
               ) -> torch.Tensor:
    """The owners' rows of window w of the stacked (S, n) buffer, in
    place: an (S, Lw) view whose row j is window w's strip of shard j in
    row j (rows ``g.stride(0) + L`` apart, L = n / S, Lw = L / windows);
    at one window the block diagonal."""
    S, n = g.shape
    L = n // S
    Lw = L // windows
    return g.as_strided((S, Lw), (g.stride(0) + L, 1),
                        g.storage_offset() + w * Lw)


def block_diagonal(g: torch.Tensor) -> torch.Tensor:
    """(S, n) stacked rows -> (n,): shard j's run [j*L, (j+1)*L) of row j,
    L = n / S.  On the stacked buffer that is every shard owner's own
    gradient contribution."""
    S, n = g.shape
    if n % S:
        raise ValueError(f"{n} elements do not split into {S} shards")
    return own_strips(g).reshape(-1)


def dequant_agg_opt_ref(p: torch.Tensor, q: torch.Tensor,
                        scales: torch.Tensor, g_own: torch.Tensor,
                        m: torch.Tensor, *, lr: float, momentum: float,
                        inv_n: float, chunk_elems: int,
                        divisor: torch.Tensor | None = None,
                        weight_decay: float = 0.0):
    """``dequant_agg_opt_chunks``' body: ``g = (q * s + g_own) * inv_n``
    with ``s`` the chunk's scale (or ``/ divisor``, a one-element f32
    tensor: the sanity gate's live count), then the Nesterov update.  p
    and m are (n,), or (R, Lr) runs read row by row (a window's strip of
    every shard; their rows may lie any distance apart); ``g_own`` has p's
    shape, or for p (n,) is the stacked (S, n) buffer, read on its block
    diagonal; q holds the n elements packed.  Returns (p', m'), contiguous
    in p's shape."""
    if p.dim() == 1 and g_own.dim() == 2:
        own = block_diagonal(g_own)
    else:
        own = g_own.reshape(-1)
    deq = (q.float().reshape(-1, chunk_elems)
           * scales.float()[:, None]).reshape(-1)
    g = deq + own.float()
    g = g / divisor if divisor is not None else g * inv_n
    p2, m2 = _nesterov(p.reshape(-1), g, m.reshape(-1), lr, momentum,
                       weight_decay)
    return p2.view(p.shape), m2.view(m.shape)


HEALTH_THREADS, HEALTH_VEC, WARP = 256, 4, 32


def _halve(x: torch.Tensor) -> torch.Tensor:
    """Pairwise tree over the last dim, first half + second half until one
    is left: the __shfl_down_sync tree of the kernel (lane l takes lane l
    + offset's value)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def health_chunks_ref(g: torch.Tensor) -> torch.Tensor:
    """``health_chunks``' body: g (n_chunks, chunk_elems), f32 or bf16 ->
    (n_chunks,) f32 sums of squares, in the kernel's order: thread t of a
    256-thread block adds the squares of the 4-element vectors at t*4 +
    k*1024, k = 0, 1, ..., one by one to a running sum (the chunk is
    padded with zeros to whole 1024-element rows, which add exactly
    nothing), then a tree over each warp's 32 lanes and one over the 8
    warps.  NaN and Inf propagate."""
    nc, ce = g.shape
    row = HEALTH_THREADS * HEALTH_VEC
    x = g.float()
    if ce % row:
        x = torch.nn.functional.pad(x, (0, row - ce % row))
    sq = (x * x).view(nc, -1, HEALTH_THREADS, HEALTH_VEC)
    acc = torch.zeros(nc, HEALTH_THREADS, dtype=torch.float32,
                      device=g.device)
    for k in range(sq.shape[1]):
        for c in range(HEALTH_VEC):
            acc = acc + sq[:, k, :, c]
    warps = _halve(acc.view(nc, HEALTH_THREADS // WARP, WARP))
    return _halve(warps)


def health_scan_ref(g: torch.Tensor) -> torch.Tensor:
    """The reference's oracle of the health pass: the f32 sum of squares of
    all of ``g`` (0-dim; NaN/Inf propagate)."""
    return torch.sum(torch.square(g.float()))
