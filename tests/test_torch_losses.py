"""The PyTorch port's fitting losses held against the JAX package on the
CPU: compute_error, the identity regularisers, the seeded VGG19 loss and
the lr schedule.

Tolerances, each with its reason: loss values rtol 1e-5 (fp32 means taken
in another order); their gradients atol 1e-9 (elementwise, no sums); the
VGG loss rtol 1e-4 and its gradient atol 1e-4 * scale + rtol 1e-3 (fp32
convolutions summed in another order); the schedule rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guassianhand_tpu.train import fit as jfit
from guassianhand_tpu.train import losses as jlosses
from guassianhand_tpu.train import vgg as jvgg
from guassianhand_tpu_torch.compat.from_jax import load_jax_vgg
from guassianhand_tpu_torch.train import losses
from guassianhand_tpu_torch.train.fit import (FitConfig, lr_schedule,
                                              make_optimizer)
from guassianhand_tpu_torch.train.vgg import VGGLoss, _random_params
from tests.torch_parity import one_torch_thread, to_torch  # noqa: F401


def close(got, want, atol=0.0, rtol=1e-5, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=msg)


def test_lr_schedule_matches_optax():
    cfg = FitConfig(steps_per_epoch=3)
    want = jfit.lr_schedule(jfit.FitConfig(steps_per_epoch=3))
    counts = sorted({m * 3 + d for m in cfg.milestones for d in (-1, 0, 1)}
                    | {0, 400})
    for c in counts:
        assert lr_schedule(cfg)(c) == pytest.approx(float(want(c)), rel=1e-6)
    # the optimiser's lr follows it, one schedule step per update
    model = torch.nn.Module()
    model.map_bias = torch.nn.Parameter(torch.zeros(2))
    opt, sched = make_optimizer(model, cfg)
    for c in range(20):
        assert opt.param_groups[0]["lr"] == pytest.approx(
            lr_schedule(cfg)(c), rel=1e-12)
        opt.step()
        sched.step()


def test_losses_and_regularisers_match_jax():
    """compute_error (L1, L2, Lp, mask) and the identity regularisers (wide
    and narrow color_b), values and gradients; a third of the predicted
    pixels equal their targets, where |x|'s gradient is 1 in both packages,
    and color_b holds zeros, where it is 0."""
    rng = np.random.RandomState(14)
    pred = rng.uniform(0, 1, (2, 12, 10, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (2, 12, 10, 3)).astype(np.float32)
    target[:, :4] = pred[:, :4]
    pmask = rng.uniform(-0.01, 1.0, (2, 12, 10)).astype(np.float32)
    tmask = (rng.uniform(size=(2, 12, 10)) > 0.5).astype(np.float32)
    wts = dict(l1=10.0, l2=0.5, lp=0.2)

    def j_loss(p, m):
        return jlosses.compute_error(p, jnp.asarray(target), m,
                                     jnp.asarray(tmask),
                                     weights=jlosses.LossWeights(**wts))

    (_, j_err), j_grads = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(pred, pmask)
    p, m = to_torch(pred).requires_grad_(), to_torch(pmask).requires_grad_()
    total, err = losses.compute_error(p, to_torch(target), m, to_torch(tmask),
                                      weights=losses.LossWeights(**wts))
    assert set(err) == set(j_err) == {"e_pix_l1", "e_pix_l2", "e_pix_lp",
                                      "mask_loss"}
    for k in err:
        close(err[k], j_err[k], msg=k)
    for got, want in zip(torch.autograd.grad(total, [p, m]), j_grads):
        close(got, want, atol=1e-9)

    for channels in (48, 3):
        cb = rng.normal(size=(channels, 8, 16)).astype(np.float32)
        cb[:, :2] = 0.0
        maps = {"color_b": cb,
                "opacity_b": rng.normal(size=(1, 8, 16)).astype(np.float32),
                "map_bias": rng.normal(size=(80, 4, 8)).astype(np.float32)}
        j_reg, j_g = jax.jit(jax.value_and_grad(
            jlosses.identity_regularizers))(maps)
        t_maps = {k: to_torch(v).requires_grad_() for k, v in maps.items()}
        reg = losses.identity_regularizers(t_maps)
        close(reg, j_reg)
        for k, g in zip(t_maps, torch.autograd.grad(reg, list(t_maps.values()))):
            close(g, j_g[k], atol=1e-12, msg=k)
        assert float(torch.autograd.grad(
            losses.identity_regularizers(t_maps), t_maps["color_b"])[0][
                :, :2].abs().max()) == 0.0


def test_vgg_matches_jax():
    """The seeded random VGG19 is the JAX package's to the bit, loaded
    through compat.from_jax.load_jax_vgg too; the loss and its gradient at
    32^2 agree at rtol 1e-4 (fp32 convolutions summed in another order)."""
    port, jax_vgg = VGGLoss(), jvgg.VGGLoss()
    for i, (w, b) in enumerate(jvgg._random_params(0)):
        np.testing.assert_array_equal(_random_params(0)[i][0], w)
        np.testing.assert_array_equal(getattr(port, f"w{i}").numpy(), w)
        np.testing.assert_array_equal(getattr(port, f"b{i}").numpy(), b)
    carried = VGGLoss()
    carried.w0.zero_()
    load_jax_vgg(carried, jax_vgg.params)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(carried.state_dict()[k], v, atol=0, rtol=0)
    assert not port.pretrained and not any(True for _ in port.parameters())

    rng = np.random.RandomState(15)
    x = rng.uniform(0, 1, (1, 3, 32, 32)).astype(np.float32)
    y = rng.uniform(0, 1, (1, 3, 32, 32)).astype(np.float32)
    y[..., :8, :] = x[..., :8, :]         # features that agree exactly
    want, want_g = jax.jit(jax.value_and_grad(jax_vgg))(x, y)
    xt = to_torch(x).requires_grad_()
    loss = port(xt, to_torch(y))
    (g,) = torch.autograd.grad(loss, [xt])
    close(loss, want, rtol=1e-4)
    close(g, want_g, atol=1e-4 * float(np.abs(want_g).max()), rtol=1e-3)
