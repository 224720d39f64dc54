"""Flash attention: kernel B2 (the forward), its plain PyTorch version,
and the blockwise-recompute backward.

Counterpart of the flash section of ``horovod_tpu/ops/pallas_kernels.py``
(``:139-549``): ``_flash_fwd_kernel`` / ``_flash_forward`` (``:144``,
``:260``) become ``csrc/flash_attn.cu``, built with ``nvcc`` for
``sm_90a`` at first use and called through ctypes on PyTorch's current
stream; ``_flash_bwd_chunked`` (``:337``), a ``lax.scan`` in the JAX
package and no Pallas kernel, is plain PyTorch here; the two
``jax.custom_vjp`` s (``:418-497``) become one ``torch.autograd.Function``.

Layout ``[B, T, H, D]`` throughout.  The kernel reads q, k and v by
their strides (they may be views of one qkv tensor); it takes float32 or
bfloat16 and head dims 16, 32, 64 and 128, and raises on anything else.
On a CPU tensor :func:`flash_forward` computes
:func:`flash_forward_reference` instead.  ``flash_forward.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

NEG_INF = -1e30
KERNEL_BLOCK = 64  # query and key tile of csrc/flash_attn.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def _mask(t: int, k0: int, k1: int, causal: bool,
          segments: Optional[torch.Tensor], device) -> torch.Tensor:
    """Keys ``k0:k1`` that each query may see: ``[T, k1-k0]``, or
    ``[B, 1, T, k1-k0]`` with segments (keys past T never occur here)."""
    q_pos = torch.arange(t, device=device)[:, None]
    k_pos = torch.arange(k0, k1, device=device)[None, :]
    mask = k_pos < t
    if causal:
        mask = mask & (q_pos >= k_pos)
    if segments is not None:
        seg = segments.to(torch.int32)
        mask = mask & (seg[:, :, None] == seg[:, None, k0:k1])[:, None]
    return mask


def flash_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    scale: float, segments: Optional[torch.Tensor] = None,
    block_k: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B2: ``(out [B,T,H,D] in q's dtype, lse [B,H,T]
    float32)``.

    The online softmax of ``_flash_fwd_kernel`` over key blocks of
    ``block_k`` (``min(block_k, max(T, 16))`` as the JAX wrapper cuts
    it), so that ``p`` is rounded to ``v``'s dtype against the same
    running maximum as in a kernel with that key block."""
    b, t, h, d = q.shape
    block_k = min(block_k, max(t, 16))
    qf = q.float().transpose(1, 2)  # [B, H, T, D]
    kf = k.float().transpose(1, 2)
    vt = v.transpose(1, 2)
    m = torch.full((b, h, t, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, t, 1), device=q.device)
    acc = torch.zeros((b, h, t, d), device=q.device)
    for k0 in range(0, t, block_k):
        k1 = min(k0 + block_k, t)
        mask = _mask(t, k0, k1, causal, segments, q.device)
        s = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.where(m_new <= NEG_INF, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe), 0.0)
        corr = torch.exp(torch.where(m <= NEG_INF, NEG_INF, m) - m_safe)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ vt[:, :, k0:k1].float()
        m = m_new
    out = (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(torch.clamp(l, min=1e-37)))
    return out.transpose(1, 2), lse[..., 0]


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attn")
    fn = lib.hvd_flash_fwd
    if fn.argtypes is None:
        ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, ll, ll, ll, ptr, ll, ll, ll, ptr, ll, ll, ll,
                       ptr, ptr, ptr, i, i, i, i, i, ctypes.c_float, i, ptr]
        fn.restype = ctypes.c_int
    return lib


def _strided_ok(x: torch.Tensor) -> bool:
    """Rows the kernel can read 16 bytes at a time: d contiguous, the
    base and the b/t/h strides 16-byte aligned."""
    es = x.element_size()
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(s * es % 16 == 0 for s in x.stride()[:3]))


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    scale: float, segments: Optional[torch.Tensor] = None,
    block_k: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: ``(out [B,T,H,D], lse [B,H,T] float32)``.

    CPU tensors take :func:`flash_forward_reference` with ``block_k``.
    CUDA tensors launch ``csrc/flash_attn.cu`` (64-key tiles, whatever
    ``block_k``) on the current stream, or raise for a dtype, head dim,
    shape or layout it does not take: q, k and v may be strided views
    (the model passes views of one qkv tensor) whose rows of D elements
    are contiguous and 16-byte aligned."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal, scale, segments,
                                       block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward: unsupported device {q.device}")
    b, t, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_forward: q, k, v must share [B, T, H, D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_forward: the kernel takes float32 or bfloat16 q, k, v "
            f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_forward: the kernel takes head dims {HEAD_DIMS}, got {d}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("flash_forward: q, k, v on different devices")
    if not all(_strided_ok(x) for x in (q, k, v)):
        raise ValueError(
            "flash_forward: the kernel reads rows of D contiguous elements, "
            "16-byte aligned; pass contiguous q, k, v"
        )
    seg_ptr = None
    if segments is not None:
        if tuple(segments.shape) != (b, t):
            raise ValueError(f"segments must be [B, T] = {(b, t)}, got "
                             f"{tuple(segments.shape)}")
        segments = segments.to(device=q.device, dtype=torch.int32).contiguous()
        seg_ptr = segments.data_ptr()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse.fill_(NEG_INF)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.hvd_flash_fwd(
            q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3], seg_ptr, out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODE[q.dtype], b, t, h, d, float(scale),
            int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {rc}")
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def flash_backward_chunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, causal: bool, scale: float,
    chunk: int, segments: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blockwise-recompute flash backward (``_flash_bwd_chunked``): with
    ``delta = rowsum(do * o)``, over key chunks of ``chunk``,
    ``p = exp(s - lse)``, ``dv = pᵀ·do``, ``ds = p * (do·vᵀ - delta)``,
    ``dq += ds·k·scale``, ``dk = dsᵀ·q·scale``, in float32, where the
    scores ``s = (q·scale)·kᵀ`` scale q before the product as the JAX
    backward does.  Returns (dq, dk, dv) in q's dtype."""
    b, t, h, d = q.shape
    in_dtype = q.dtype
    qh = q.float().transpose(1, 2)  # [B, H, T, D]
    kh = k.float().transpose(1, 2)
    vh = v.float().transpose(1, 2)
    doh = do.float().transpose(1, 2)
    delta = (doh * o.float().transpose(1, 2)).sum(-1, keepdim=True)
    qs = qh * scale
    lse = lse[..., None]
    chunk = min(chunk, t)
    dq = torch.zeros_like(qh)
    dk = torch.empty_like(kh)
    dv = torch.empty_like(vh)
    for k0 in range(0, t, chunk):
        k1 = min(k0 + chunk, t)
        kc, vc = kh[:, :, k0:k1], vh[:, :, k0:k1]
        mask = _mask(t, k0, k1, causal, segments, q.device)
        s = qs @ kc.transpose(-1, -2)
        p = torch.where(mask, torch.exp(s - lse), 0.0)
        dv[:, :, k0:k1] = p.transpose(-1, -2) @ doh
        ds = p * (doh @ vc.transpose(-1, -2) - delta)
        dq += (ds @ kc) * scale
        dk[:, :, k0:k1] = (ds.transpose(-1, -2) @ qh) * scale
    return tuple(x.transpose(1, 2).to(in_dtype) for x in (dq, dk, dv))


class _FlashAttention(torch.autograd.Function):
    """B2 forward, chunked backward; the integer segment ids get no
    gradient (the ``float0`` cotangent of ``_flash_packed_bwd_rule``)."""

    @staticmethod
    def forward(ctx, q, k, v, segments, causal, scale, block_k, bwd_chunk):
        out, lse = flash_forward(q, k, v, causal, scale, segments, block_k)
        ctx.save_for_backward(q, k, v, out, lse, segments)
        ctx.causal, ctx.scale, ctx.bwd_chunk = causal, scale, bwd_chunk
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, segments = ctx.saved_tensors
        dq, dk, dv = flash_backward_chunked(
            q, k, v, out, lse, do, ctx.causal, ctx.scale, ctx.bwd_chunk,
            segments,
        )
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
    scale: Optional[float] = None, block_q: int = 512, block_k: int = 512,
    bwd_chunk: int = 512, segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention ``[B, T, H, D] -> [B, T, H, D]`` (``flash_attention``
    of the JAX package, same signature and errors): the forward is B2,
    the backward recomputes blockwise from the saved row logsumexp.
    ``segment_ids`` ([B, T] integers) restricts each token to keys of its
    own segment (packed rows).  ``block_q`` is the JAX kernel's query
    tile and changes nothing here; ``block_k`` is the key block of the
    plain version that CPU tensors take."""
    del block_q  # rows are independent: the query tile changes no value
    if k.shape[1] != q.shape[1] or v.shape[1] != q.shape[1]:
        raise ValueError(
            f"flash_attention requires equal q/k/v sequence lengths, got "
            f"q T={q.shape[1]}, k T={k.shape[1]}, v T={v.shape[1]}; use "
            "full_attention for unequal lengths"
        )
    if segment_ids is not None and tuple(segment_ids.shape) != tuple(q.shape[:2]):
        raise ValueError(
            f"segment_ids must be [B, T] = {tuple(q.shape[:2])}, got "
            f"{tuple(segment_ids.shape)}"
        )
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32)
    return _FlashAttention.apply(q, k, v, segment_ids, bool(causal),
                                 float(scale), block_k, bwd_chunk)
