"""The slice as a whole on the CPU: the 3-step TINY fit of
tests/test_torch_train.py with both kernel switches on, held against JAX
``make_fit_step`` with ``projection_impl="pallas"`` (Pallas interpret mode)
and the scan attention. The port runs ``projection_impl="pallas"`` (the
fused projection's twins and its hand-derived adjoint) and
``GH_FLASH_ATTN=1`` (the flash attention's twins), so its whole fit goes
through the functions the five kernels compute.

The setup (JTINY, the seeded weights carried across, the scene, the JAX
batch) is tests/torch_parity.py::fit_against_jax, shared with
tests/test_torch_train.py, and so are the checks and their tolerances
(losses rtol 1e-3; first gradients atol 2e-4 * scale + rtol 2e-3; the
parameters after 3 steps by ``adam_close``).
"""
import dataclasses
from unittest import mock

import pytest

from guassianhand_tpu_torch.ops import blockwise_attention, rasterize
from tests.test_model import HW, TINY
from tests.test_torch_train import (JTINY, STEPS, check_first_gradients,
                                    check_losses, check_parameters_after_steps)
from tests.torch_parity import fit_against_jax, one_torch_thread  # noqa: F401

JTINY_PALLAS = dataclasses.replace(JTINY, renderer=dataclasses.replace(
    JTINY.renderer, raster=dataclasses.replace(
        JTINY.renderer.raster, projection_impl="pallas")))


@pytest.fixture(scope="module")
def kernels_fit_run():
    """The fit of both packages with the switches on, and how often the
    port's fit took the fused projection and the flash attention."""
    project = mock.Mock(wraps=rasterize.PROJECTIONS["pallas"])
    attend = mock.Mock(wraps=blockwise_attention.flash_attention)
    with mock.patch.dict(rasterize.PROJECTIONS, {"pallas": project}), \
            mock.patch.object(blockwise_attention, "flash_attention", attend):
        run = fit_against_jax(JTINY_PALLAS, TINY, HW, STEPS,
                              port_env={"GH_FLASH_ATTN": "1"})
    run["calls"] = {"project": project.call_count,
                    "attention": attend.call_count}
    return run


def test_kernel_fit_takes_both_kernel_routes(kernels_fit_run):
    cfg = kernels_fit_run["model"].cfg.renderer.raster
    assert cfg.projection_impl == "pallas"
    # one projection and one interaction attention a step
    assert kernels_fit_run["calls"] == {"project": STEPS, "attention": STEPS}


def test_kernel_fit_first_gradients_match_jax(kernels_fit_run):
    check_first_gradients(kernels_fit_run)


def test_kernel_fit_losses_match_jax(kernels_fit_run):
    check_losses(kernels_fit_run)


def test_kernel_fit_parameters_match_jax_after_three_steps(kernels_fit_run):
    check_parameters_after_steps(kernels_fit_run)
