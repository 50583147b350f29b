"""2 fit steps of the PyTorch port on an InterHand2.6M batch held against
the JAX package's fit step: the batch is JAX's ``InterHandDataset.
load_sample(0)`` on the fake layout of ``tests/torch_interhand_layout.py``
(64-vertex synthetic MANO, edge_subdivide 1, 64^2 JPEGs), handed to both
packages (the port's own batch differs in the last bits of the points and
a few points of the interaction mask, ROADMAP.md Queue C; its load_sample
is held against JAX's in tests/test_torch_interhand.py).

The setup and the checks are tests/torch_parity.py::fit_against_jax's and
tests/test_torch_train.py's, with their tolerances: losses rtol 1e-3; the
first gradients atol 2e-4 * scale + rtol 2e-3; the parameters after the
steps by ``adam_close``.
"""
import numpy as np
import pytest

from guassianhand_tpu.data import interhand as jinterhand
from tests.test_model import HW, TINY
from tests.test_torch_train import (JTINY, check_first_gradients,
                                    check_losses, check_parameters_after_steps)
from tests.torch_parity import fit_against_jax, one_torch_thread  # noqa: F401
from tests import torch_interhand_layout as ih_layout

STEPS = 2
# the model's inputs and the fit's targets
BATCH_KEYS = ("points", "points_tar", "vert_uv", "inter_mask", "mano_pose",
              "c2w", "intrinsic_normed", "w2c_render", "K_render",
              "background", "target_rgb", "target_mask")


@pytest.fixture(scope="module")
def interhand_fit_run(tmp_path_factory):
    layout = ih_layout.write_interhand_layout(
        tmp_path_factory.mktemp("interhand"), n_vertices=64, hw=HW,
        test_frames=0)
    dataset = jinterhand.InterHandDataset(jinterhand.InterHandConfig(
        data_root=layout["data_root"], annot_path=layout["annot_path"],
        mano_models_path=layout["mano"], edge_subdivide=1, split="train"))
    sample = dataset.load_sample(0)
    batch = {k: np.asarray(sample[k]) for k in BATCH_KEYS}
    assert 0 < batch["inter_mask"].sum() < batch["inter_mask"].size
    return fit_against_jax(JTINY, TINY, HW, STEPS, batch=batch)


def test_interhand_fit_losses_match_jax(interhand_fit_run):
    check_losses(interhand_fit_run)


def test_interhand_fit_first_gradients_match_jax(interhand_fit_run):
    check_first_gradients(interhand_fit_run)


def test_interhand_fit_parameters_match_jax(interhand_fit_run):
    check_parameters_after_steps(interhand_fit_run)
