"""Flash attention: kernel B2 (the forward), its plain PyTorch version,
and the blockwise-recompute backward.

Counterpart of the flash section of ``horovod_tpu/ops/pallas_kernels.py``
(``:139-549``): ``_flash_fwd_kernel`` / ``_flash_forward`` (``:144``,
``:260``) become two CUDA kernels, built with ``nvcc`` for ``sm_90a`` at
first use and called through ctypes on PyTorch's current stream;
``_flash_bwd_chunked`` (``:337``), a ``lax.scan`` in the JAX package and
no Pallas kernel, is plain PyTorch here; the two ``jax.custom_vjp`` s
(``:418-497``) become one ``torch.autograd.Function``.

B2 has two routes, chosen by dtype and head dim alone (:func:`route`):

* ``"wgmma"``, ``csrc/flash_attn_sm90.cu``: bf16 at head dims 64 and
  128, Hopper's wgmma fed by TMA, 128-query by 128-key tiles
  (:func:`flash_forward_wgmma`).  TMA reads q, k and v by their strides,
  so the base and the b/t/h strides must be multiples of 16 bytes; a
  layout it cannot address raises.
* ``"mma"``, ``csrc/flash_attn.cu``: float32 at head dims 16 to 128 and
  bf16 at 16 and 32, ``mma.sync`` on 64 by 64 tiles
  (:func:`flash_forward_mma`).

Layout ``[B, T, H, D]`` throughout; q, k and v may be strided views of
one qkv tensor.  On a CPU tensor every entry point computes
:func:`flash_forward_reference` instead.  ``flash_forward.launches``
counts every B2 launch, ``flash_forward_wgmma.launches`` and
``flash_forward_mma.launches`` each route's, as the device runs them: a
launch recorded into a CUDA graph is not counted at capture, and is
counted once on each replay (``TrainStep``,
``optim/distributed_optimizer.py``, over the wrappers in
``ops.LAUNCH_COUNTED``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, counted

NEG_INF = -1e30
# Key tile of each route: p is rounded to bf16 against the running
# maximum of each key tile, so the plain version is compared with it.
KERNEL_BLOCK = {"wgmma": 128, "mma": 64}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)


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


def route(dtype: torch.dtype, d: int) -> str:
    """The B2 route that serves q of ``dtype`` and head dim ``d`` on the
    card: ``"wgmma"`` for bf16 at 64 and 128, else ``"mma"``."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS else "mma"


_ENTRY = {"mma": "hvd_flash_fwd", "wgmma": "hvd_flash_fwd_sm90"}
_SOURCE = {"mma": "flash_attn", "wgmma": "flash_attn_sm90"}


def _library(which: str) -> ctypes.CDLL:
    lib = build.load(_SOURCE[which])
    fn = getattr(lib, _ENTRY[which])
    if fn.argtypes is None:
        ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        dtype = [i] if which == "mma" else []
        fn.argtypes = [ptr, ll, ll, ll, ptr, ll, ll, ll, ptr, ll, ll, ll,
                       ptr, ptr, ptr, *dtype, i, i, i, i, ctypes.c_float, i, ptr]
        fn.restype = ctypes.c_int
    return lib


def sm90_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block of the wgmma route at head dim
    ``d`` (builds the library on first use)."""
    lib = _library("wgmma")
    lib.hvd_flash_fwd_sm90_smem.argtypes = [ctypes.c_int]
    lib.hvd_flash_fwd_sm90_smem.restype = ctypes.c_int
    return int(lib.hvd_flash_fwd_sm90_smem(d))


def _strided_ok(x: torch.Tensor) -> bool:
    """Rows the kernels can read 16 bytes at a time: d contiguous, the
    base and the b/t/h strides 16-byte aligned."""
    es = x.element_size()
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(s * es % 16 == 0 for s in x.stride()[:3]))


def _tma_ok(x: torch.Tensor) -> bool:
    """What a TMA tensor map can address: as :func:`_strided_ok`, with
    the b/t/h strides positive and under 2^40 bytes."""
    es = x.element_size()
    return _strided_ok(x) and all(0 < s * es < 1 << 40 for s in x.stride()[:3])


def _checked(name: str, q, k, v, segments, dtypes, head_dims, layout_ok):
    """Validate a launch of one route; the segments as the kernel reads
    them ([B, T] int32, contiguous, on q's card) or None."""
    b, t, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"{name}: q, k, v must share [B, T, H, D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{name}: the kernel takes {', '.join(map(str, dtypes))} q, k, v "
            f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d not in head_dims:
        raise ValueError(
            f"{name}: the kernel takes head dims {head_dims}, got {d}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on different devices")
    if not all(layout_ok(x) for x in (q, k, v)):
        raise ValueError(
            f"{name}: the kernel reads rows of D contiguous elements, "
            "16-byte aligned, at b/t/h strides that are multiples of 16 "
            "bytes (positive, for TMA); pass contiguous q, k, v"
        )
    if segments is None:
        return None
    if tuple(segments.shape) != (b, t):
        raise ValueError(f"segments must be [B, T] = {(b, t)}, got "
                         f"{tuple(segments.shape)}")
    return segments.to(device=q.device, dtype=torch.int32).contiguous()


def _launch(which: str, q, k, v, causal, scale, segments):
    """Launch route ``which`` on validated CUDA tensors."""
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse.fill_(NEG_INF)
    lib = _library(which)
    dtype = [_DTYPE_CODE[q.dtype]] if which == "mma" else []
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, _ENTRY[which])(
            q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3],
            None if segments is None else segments.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *dtype, b, t, h, d, float(scale), int(bool(causal)),
            stream,
        )
    if rc < 0:
        raise RuntimeError(f"flash attention ({which}): cuTensorMapEncodeTiled "
                           f"failed with CUresult {-rc}")
    if rc != 0:
        raise RuntimeError(f"flash attention ({which}) kernel launch failed: "
                           f"cudaError {rc}")
    flash_forward.launches += 1
    _ROUTES[which].launches += 1
    return out, lse


def _on_card(name: str, q: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


def flash_forward_wgmma(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    scale: float, segments: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2's Hopper route (``csrc/flash_attn_sm90.cu``): bf16 q, k, v at
    head dims 64 and 128; raises on anything else, and on a layout TMA
    cannot address.  CPU tensors take the plain version at its key tile
    (128)."""
    if not _on_card("flash_forward_wgmma", q):
        return flash_forward_reference(q, k, v, causal, scale, segments,
                                       KERNEL_BLOCK["wgmma"])
    seg = _checked("flash_forward_wgmma", q, k, v, segments,
                   (torch.bfloat16,), WGMMA_HEAD_DIMS, _tma_ok)
    return _launch("wgmma", q, k, v, causal, scale, seg)


def flash_forward_mma(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    scale: float, segments: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2's retained route (``csrc/flash_attn.cu``, ``mma.sync``): float32
    or bf16 at head dims 16, 32, 64 and 128, 64-key tiles.  The main path
    sends it float32 and bf16 at 16 and 32; it takes the others too, so
    that the two routes can be held side by side.  CPU tensors take the
    plain version at its key tile (64)."""
    if not _on_card("flash_forward_mma", q):
        return flash_forward_reference(q, k, v, causal, scale, segments,
                                       KERNEL_BLOCK["mma"])
    seg = _checked("flash_forward_mma", q, k, v, segments,
                   tuple(_DTYPE_CODE), HEAD_DIMS, _strided_ok)
    return _launch("mma", q, k, v, causal, scale, seg)


_ROUTES = {"wgmma": flash_forward_wgmma, "mma": flash_forward_mma}


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    scale: float, segments: Optional[torch.Tensor] = None,
    block_k: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: ``(out [B,T,H,D], lse [B,H,T] float32)``.

    CPU tensors take :func:`flash_forward_reference` with ``block_k``.
    CUDA tensors launch the route :func:`route` names for their dtype
    and head dim (whatever ``block_k``) on the current stream, or raise
    for a dtype, head dim, shape or layout it does not take: q, k and v
    may be strided views (the model passes views of one qkv tensor)
    whose rows of D elements are contiguous and 16-byte aligned."""
    if not _on_card("flash_forward", q):
        return flash_forward_reference(q, k, v, causal, scale, segments,
                                       block_k)
    return _ROUTES[route(q.dtype, q.shape[-1])](q, k, v, causal, scale,
                                                segments)


for _fn in (flash_forward, flash_forward_wgmma, flash_forward_mma):
    counted(_fn)


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
