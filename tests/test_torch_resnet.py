"""The port's ResNet against the flax ResNet on the same weights.

A tiny ResNet (stage sizes [1,1,1,1], 8 filters, 10 classes, 32x32,
batch 4) is initialised by flax, carried across with
``load_jax_params``, and both run one training-mode forward on the same
NHWC input made with numpy.  In float32 the logits and the updated
BatchNorm running statistics agree to rtol 1e-4 / atol 1e-4: the two
packages sum the convolutions and the fast BatchNorm variance
(E[x²] - E[x]², which cancels) in different orders.  At 32x32 the stem
output is even, so the max pool and the stride-2 3x3 convs pad (0, 1);
the symmetric (1, 1) padding of ``nn.MaxPool2d``/``Conv2d(padding=1)``
fails the same comparison.

The ``space_to_depth`` stem is held the same way at the same size
(the stem's fold is a reshape, bitwise against the JAX function; the
4x4 conv sums in another order than flax's, within the same
tolerance).  ResNet-101 and -152, and ResNet-50 with the folded stem,
have exactly flax's parameter count (``jax.eval_shape`` of the flax
init: no weights are made).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import resnet as jresnet
from horovod_tpu.models.resnet import ResNet as JaxResNet
from horovod_tpu_torch.models import resnet as tresnet

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-4


_FLAX = {}


def _flax(dtype, stem="conv7"):
    """(jitted train apply, jitted eval apply, variables), built once per
    dtype and stem: op-by-op flax init and apply would compile every op."""
    if (dtype, stem) not in _FLAX:
        model = JaxResNet(stage_sizes=[1, 1, 1, 1], num_filters=8,
                          num_classes=10, dtype=dtype, stem=stem)
        variables = jax.jit(lambda x: model.init(
            jax.random.PRNGKey(0), x, train=True
        ))(jnp.zeros((1, 32, 32, 3)))
        train = jax.jit(lambda v, x: model.apply(
            v, x, train=True, mutable=["batch_stats"]
        ))
        evaluate = jax.jit(lambda v, x: model.apply(v, x, train=False))
        _FLAX[dtype, stem] = (train, evaluate, variables)
    return _FLAX[dtype, stem]


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _port(variables, dtype, stem="conv7"):
    model = tresnet.ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                           dtype=dtype, device="cpu", stem=stem)
    sd = tresnet.load_jax_params(
        _numpy_tree(variables["params"]),
        _numpy_tree(variables["batch_stats"]),
    )
    model.load_state_dict(sd, strict=True)
    return model


def _batch(seed=0):
    return np.random.default_rng(seed).standard_normal((4, 32, 32, 3)) \
        .astype(np.float32)


def _run_both(x):
    train, _, variables = _flax(jnp.float32)
    logits_j, upd = train(variables, jnp.asarray(x))
    model = _port(variables, torch.float32)
    model.train()
    logits_t = model(torch.from_numpy(x))
    return (np.asarray(logits_j), logits_t.detach().numpy(),
            _numpy_tree(upd["batch_stats"]), model)


def test_logits_and_running_stats_match_flax():
    x = _batch()
    lj, lt, stats_j, model = _run_both(x)
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
    want = tresnet.load_jax_params(
        _numpy_tree(_flax(jnp.float32)[2]["params"]), stats_j
    )
    sd = model.state_dict()
    for name, ref in want.items():
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(
                sd[name].numpy(), ref.numpy(), rtol=RTOL, atol=ATOL,
                err_msg=name,
            )


def test_eval_mode_uses_running_stats():
    x = _batch(1)
    _, evaluate, variables = _flax(jnp.float32)
    lj = evaluate(variables, jnp.asarray(x))
    model = _port(variables, torch.float32)
    model.eval()
    np.testing.assert_allclose(
        model(torch.from_numpy(x)).detach().numpy(), np.asarray(lj),
        rtol=RTOL, atol=ATOL,
    )


def test_symmetric_padding_would_not_match(monkeypatch):
    x = _batch()
    lj, lt, _, _ = _run_both(x)
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
    monkeypatch.setattr(
        tresnet, "_same_pads", lambda size, k, stride: (k // 2, k // 2)
    )
    _, lt_sym, _, _ = _run_both(x)
    assert not np.allclose(lt_sym, lj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("size,k,stride,want", [
    (112, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (56, 3, 1, (1, 1)),
    (56, 1, 2, (0, 0)), (8, 3, 2, (0, 1)),
])
def test_same_pads_match_xla(size, k, stride, want):
    assert tresnet._same_pads(size, k, stride) == want
    # XLA's own SAME rule, through lax.padtype_to_pads.
    assert tuple(jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]) == want


def test_bf16_model_matches_flax_loosely():
    """bf16 compute: logits within 5e-2 absolute (bf16 keeps ~3 digits
    and the two packages round at the same places but sum differently)."""
    x = _batch(2)
    train, _, variables = _flax(jnp.bfloat16)
    lj, _ = train(variables, jnp.asarray(x))
    model = _port(variables, torch.bfloat16)
    model.train()
    lt = model(torch.from_numpy(x)).detach()
    assert lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=5e-2)


def test_resnet50_layout():
    model = tresnet.ResNet50(num_classes=1000, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == 25_557_032  # flax ResNet50 at its published widths
    assert len(model.blocks) == 16


def test_space_to_depth_stem_matches_flax():
    x = _batch(3)
    train, _, variables = _flax(jnp.float32, "space_to_depth")
    lj, _ = train(variables, jnp.asarray(x))
    model = _port(variables, torch.float32, "space_to_depth")
    assert model.conv_init_s2d.weight.shape == (8, 12, 4, 4)
    model.train()
    lt = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(lt, np.asarray(lj), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="even input"):
        model(torch.zeros(1, 33, 32, 3))


def test_space_to_depth_fold_is_bitwise_with_jax():
    x = np.random.default_rng(4).standard_normal((2, 6, 8, 3)).astype(np.float32)
    want = np.asarray(jresnet.space_to_depth(jnp.asarray(x), 2))
    np.testing.assert_array_equal(
        tresnet.space_to_depth(torch.from_numpy(x), 2).numpy(), want)


@pytest.mark.parametrize("depth,stem", [
    (101, "conv7"), (152, "conv7"), (50, "space_to_depth"),
])
def test_parameter_count_matches_flax(depth, stem):
    jmodel = getattr(jresnet, f"ResNet{depth}")(num_classes=1000, stem=stem)
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=True),
        jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32),
    )
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    model = getattr(tresnet, f"ResNet{depth}")(num_classes=1000, stem=stem,
                                               device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
    assert len(model.blocks) == sum(jmodel.stage_sizes)
