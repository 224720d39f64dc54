"""Kernel B2's two routes, as far as the CPU reaches them.

Which route serves which dtype and head dim, the layouts the wgmma
route's TMA tensor maps can address (strided views of one
``[B, T, 3, H, D]`` qkv tensor, as the model passes them, and the ones
it refuses), and that CPU tensors take the plain version through every
entry point at that entry point's key tile.  The kernels themselves run
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import contextlib

import pytest
import torch

from horovod_tpu_torch.ops import flash

torch.set_num_threads(2)


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread for a bitwise comparison of two float32 GEMM
    computations: on a loaded host, MKL's threaded sgemm need not give
    the same bits from one call to the next."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 32, "mma"),
    (torch.float32, 16, "mma"),
    (torch.float32, 64, "mma"),
    (torch.float32, 128, "mma"),
])
def test_route_by_dtype_and_head_dim(dtype, d, want):
    assert flash.route(dtype, d) == want
    assert flash.KERNEL_BLOCK[flash.route(dtype, d)] == {"wgmma": 128, "mma": 64}[want]


def _views(b, t, h, d, dtype=torch.bfloat16):
    qkv = torch.zeros(b, t, 3, h, d, dtype=dtype)
    return qkv.unbind(2)


@pytest.mark.parametrize("d", [64, 128])
def test_tma_takes_strided_views_of_one_qkv(d):
    q, k, v = _views(2, 100, 12, d)
    assert not q.is_contiguous()
    assert q.stride() == (100 * 3 * 12 * d, 3 * 12 * d, d, 1)
    assert all(flash._tma_ok(x) for x in (q, k, v))
    assert flash._tma_ok(q.contiguous())


def test_tma_refuses_an_unaligned_base():
    d = 64
    buf = torch.zeros(1 + 2 * 16 * 4 * d, dtype=torch.bfloat16)
    q = buf[1:].view(2, 16, 4, d)  # base 2 bytes past an aligned one
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    assert not flash._tma_ok(q)
    assert not flash._strided_ok(q)


def test_tma_refuses_a_stride_that_is_not_16_bytes():
    # Rows of D + 4 elements: the h stride is 136 bytes.
    q = torch.zeros(2, 16, 4, 68, dtype=torch.bfloat16)[..., :64]
    assert q.stride(2) * 2 % 16 == 8
    assert not flash._tma_ok(q)
    # And a t stride of an odd number of 16-byte units is fine.
    q = torch.zeros(2, 16, 1, 72, dtype=torch.bfloat16)[..., :64]
    assert q.stride(1) * 2 == 144 and flash._tma_ok(q)


def test_tma_refuses_a_broadcast_stride():
    q = torch.zeros(1, 16, 1, 64, dtype=torch.bfloat16).expand(3, 16, 4, 64)
    assert q.stride(0) == 0
    assert not flash._tma_ok(q)
    assert flash._strided_ok(q)  # the mma route reads it by its strides


def test_wgmma_layout_check_names_what_it_needs():
    q = torch.zeros(2, 16, 4, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash._checked("flash_forward_wgmma", q, q, q, None, (torch.bfloat16,),
                       flash.WGMMA_HEAD_DIMS, flash._tma_ok)
    q32 = torch.zeros(2, 16, 4, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash._checked("flash_forward_wgmma", q32, q32, q32, None, (torch.bfloat16,),
                       flash.WGMMA_HEAD_DIMS, flash._tma_ok)
    f32 = torch.zeros(2, 16, 4, 64)
    with pytest.raises(TypeError):
        flash._checked("flash_forward_wgmma", f32, f32, f32, None, (torch.bfloat16,),
                       flash.WGMMA_HEAD_DIMS, flash._tma_ok)


def _inputs(b, t, h, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(dtype)
    return qkv.unbind(2)


@pytest.mark.parametrize("entry,block", [
    ("flash_forward_wgmma", 128),
    ("flash_forward_mma", 64),
])
@pytest.mark.parametrize("causal", [False, True])
def test_cpu_tensors_take_the_plain_version_at_the_routes_tile(entry, block, causal):
    q, k, v = _inputs(1, 200, 2, 64, torch.bfloat16, seed=3)
    seg = torch.tensor([[1] * 120 + [2] * 60 + [0] * 20], dtype=torch.int32)
    fn = getattr(flash, entry)
    counts = (flash.flash_forward.launches, flash.flash_forward_wgmma.launches,
              flash.flash_forward_mma.launches)
    with _one_thread():
        out, lse = fn(q, k, v, causal, 0.125, seg)
        want_o, want_l = flash.flash_forward_reference(q, k, v, causal, 0.125, seg,
                                                       block_k=block)
    assert torch.equal(out, want_o) and torch.equal(lse, want_l)
    assert counts == (flash.flash_forward.launches, flash.flash_forward_wgmma.launches,
                      flash.flash_forward_mma.launches)


def test_the_key_tile_sets_where_p_is_rounded():
    """The plain version at the two routes' tiles differs in bf16 (p is
    rounded against another running maximum), which is why each route
    is held to the plain version at its own tile."""
    q, k, v = _inputs(1, 256, 2, 64, torch.bfloat16, seed=4)
    a, _ = flash.flash_forward_reference(q, k, v, True, 0.125, block_k=64)
    b, _ = flash.flash_forward_reference(q, k, v, True, 0.125, block_k=128)
    assert not torch.equal(a, b)
    torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7, atol=2 ** -8)


def test_entry_points_refuse_other_devices():
    q = torch.zeros(1, 16, 1, 64, device="meta", dtype=torch.bfloat16)
    for fn in (flash.flash_forward_wgmma, flash.flash_forward_mma):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, q, q, True, 0.25)
