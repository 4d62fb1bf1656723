"""The classifier zoo against the JAX package's, on the CPU: the small nets
(lenet at 28 px, cifarnet at 32, illust2vec at 64; alexnet_v2 and vgg_a
at 224, batch 1) and the layer vocabulary's known pitfalls.

Each network's eval-mode logits and end points (fp32) and one train-mode
forward, with the same JAX-drawn weights bridged; the tolerances and why
are in ``tests/torch_classifier_parity.py``. The pitfalls, each against
Flax's own layer:

- ``SAME`` with stride 2 on an even input pads (0, 1), which
  ``nn.Conv2d(padding=...)`` cannot express;
- ``max_pool`` pads ``SAME`` with -inf (all-negative input);
- ``avg_pool`` counts the padded zeros (``count_include_pad``);
- the ``VALID`` fully connected convs of alexnet, overfeat and vgg leave a
  1 x 1 map only at the exact input size, and refuse a smaller one;
- batch norm in train mode normalizes with, and moves its moving variance
  toward, the biased variance (``nn.BatchNorm2d`` moves it toward the
  unbiased one), at Flax's momentum;
- lenet and cifarnet flatten NHWC before their dense layers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_classifier_parity as parity  # noqa: E402
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

from twingan_tpu.ops import local_response_norm as jax_lrn  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models import classifiers  # noqa: E402
from twingan_tpu_torch.ops.basic import local_response_norm  # noqa: E402

SIZES = dict(lenet=(28, 2), cifarnet=(32, 2), illust2vec=(64, 2), alexnet_v2=(224, 1),
             vgg_a=(224, 1))
CACHE = parity.PairCache(SIZES)
LAYER_ATOL = 1e-5


@pytest.mark.parametrize("name,mode", parity.cases(SIZES))
def test_network_matches_jax(name, mode):
    parity.run_case(CACHE, name, mode)


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("hw,kernel", [(8, 3), (8, 1), (7, 3), (6, 5)])
def test_same_stride2_pads_like_flax(hw, kernel):
    """Stride 2 on an even input: XLA pads (0, 1) for a 3x3 window."""
    x = parity.images(2, hw)
    conv = fnn.Conv(5, (kernel, kernel), strides=(2, 2), padding="SAME")
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ours = classifiers.Conv(3, 5, kernel, 2)
    ours.load_state_dict(bridge.classifier_state_dict_from_flax(variables["params"]))
    np.testing.assert_allclose(_nhwc(ours(_nchw(x))), conv.apply(variables, jnp.asarray(x)),
                               atol=LAYER_ATOL)
    if hw == 8 and kernel == 3:
        assert classifiers.same_pads(8, 3, 2) == (0, 1)


@pytest.mark.parametrize("window,stride,padding", [(3, 2, "SAME"), (3, 1, "SAME"),
                                                   (2, 2, "VALID"), (3, 2, "VALID")])
def test_pools_pad_like_flax(window, stride, padding):
    """max_pool pads with -inf (the input is all negative, so a zero pad
    would win the max); avg_pool divides by the whole window, pad
    included."""
    x = -1.0 - np.abs(parity.images(2, 7))
    ours = classifiers.max_pool(_nchw(x), window, stride, padding)
    theirs = fnn.max_pool(jnp.asarray(x), (window, window), (stride, stride), padding)
    np.testing.assert_allclose(_nhwc(ours), theirs, atol=0)
    ours = classifiers.avg_pool(_nchw(x), window, stride, padding)
    theirs = fnn.avg_pool(jnp.asarray(x), (window, window), (stride, stride), padding)
    np.testing.assert_allclose(_nhwc(ours), theirs, atol=LAYER_ATOL)
    if padding == "SAME" and stride == 1:
        corner = float(ours[0, 0, 0, 0])
        assert corner == pytest.approx(float(x[0, :2, :2, 0].sum()) / 9.0, abs=1e-6)


@pytest.mark.parametrize("name", ["alexnet_v2", "overfeat", "vgg_a"])
def test_valid_fc_convs_need_the_exact_size(name):
    net = classifiers.get_network_fn(name, 4)
    size = type(net).default_image_size
    maps = []
    net.fc6.register_forward_hook(lambda m, i, o: maps.append(tuple(o.shape[2:])))
    with torch.no_grad():
        logits, _ = net(torch.zeros(1, size, size, 3))
        assert maps == [(1, 1)] and logits.shape == (1, 4)
        with pytest.raises(RuntimeError):
            net(torch.zeros(1, size - 32, size - 32, 3))


def test_batch_norm_train_mode_is_flaxs():
    x = parity.images(4, 5) * 3.0 + 1.0
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.997, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    ours = classifiers.BatchNorm(3, 0.997, 1e-5).train()
    out = ours(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), y, atol=LAYER_ATOL)
    np.testing.assert_allclose(ours.var.numpy(), upd["batch_stats"]["var"], rtol=1e-6)
    np.testing.assert_allclose(ours.mean.numpy(), upd["batch_stats"]["mean"], rtol=1e-6)
    # nn.BatchNorm2d at momentum 1 - 0.997 moves toward the unbiased
    # variance: another moving variance from the same batch.
    ref = torch.nn.BatchNorm2d(3, eps=1e-5, momentum=0.003).train()
    ref(_nchw(x))
    assert not np.allclose(ref.running_var.numpy(), ours.var.numpy(), rtol=1e-6)
    with torch.no_grad():
        ours.eval()
        bn_eval = fnn.BatchNorm(use_running_average=True, momentum=0.997, epsilon=1e-5)
        y_eval = bn_eval.apply({"params": variables["params"],
                                "batch_stats": upd["batch_stats"]}, jnp.asarray(x))
        np.testing.assert_allclose(_nhwc(ours(_nchw(x))), y_eval, atol=LAYER_ATOL)


@pytest.mark.parametrize("name,hw", [("lenet", 28), ("cifarnet", 32)])
def test_dense_layers_flatten_nhwc(name, hw):
    """The bridged dense kernel only fits an NHWC flatten: flattening NCHW
    with the same weights gives other pre-logits."""
    jnet, variables, tnet = parity.build_pair(name, hw)
    x = parity.images(2, hw)
    _, jeps = jnet.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        _, teps = tnet(torch.from_numpy(x))
    assert parity.rel_err(teps["PreLogits"].numpy(), jeps["PreLogits"]) <= parity.EVAL_RTOL
    side = hw // 4
    tnet.fc3.register_forward_pre_hook(lambda m, args: (
        args[0].reshape(2, side, side, 64).permute(0, 3, 1, 2).reshape(2, -1),))
    with torch.no_grad():
        nchw_flat = tnet(torch.from_numpy(x))[1]["PreLogits"].numpy()
    assert parity.rel_err(nchw_flat, jeps["PreLogits"]) > 1e-3


@pytest.mark.parametrize("r,bias,alpha,beta", [(4, 1.0, 0.001 / 9.0, 0.75), (2, 2.0, 0.5, 0.5),
                                               (0, 1.0, 1.0, 1.0)])
def test_local_response_norm(r, bias, alpha, beta):
    x = parity.images(2, 5) * 4.0
    x = np.concatenate([x, x[..., ::-1] * 0.5, x[..., :2]], axis=-1)  # 8 channels
    theirs = np.asarray(jax_lrn(jnp.asarray(x), r, bias, alpha, beta))
    np.testing.assert_allclose(local_response_norm(torch.from_numpy(x), r, bias, alpha, beta),
                               theirs, rtol=1e-6, atol=1e-6)
    ours_nchw = local_response_norm(_nchw(x), r, bias, alpha, beta, dim=1)
    np.testing.assert_allclose(_nhwc(ours_nchw), theirs, rtol=1e-6, atol=1e-6)


def test_factory_names_and_planned():
    from twingan_tpu.models import classifiers as jclassifiers

    assert sorted(classifiers.NETWORKS) == sorted(jclassifiers.NETWORKS)
    assert classifiers.PLANNED == jclassifiers.PLANNED == ()
    with pytest.raises(ValueError, match="unknown network"):
        classifiers.get_network_fn("nope", 3)
    net = classifiers.get_network_fn("illust2vec", 1539)
    assert net.logits.kernel.shape == (1024, 1539)  # Flax's [in, out]
