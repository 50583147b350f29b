"""The output check fails a run whose timed path is broken underneath:
the program is patched below the harness, which runs as it always does
(its look for a card aside), and ``correct`` comes out false. Each cell
gets the faults it can have on one card: a step that leaves its state
unchanged, half of the batch left out (the rest standing for it), and an
answer altered where it is produced."""
import pytest
import torch

from benchmark.tests.conftest import run_cell, tiny


def _wrap_output(monkeypatch, owner, name, change):
    orig = getattr(owner, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        return change(dict(out))

    monkeypatch.setattr(owner, name, wrapped)


def _alter_pixel(out):
    rgb = out["comp_rgb"].clone()
    rgb[..., 3, 5, 0] += 0.5
    return {**out, "comp_rgb": rgb}


def _alter_view(out):
    """One view of the answer brightened: the drive compares each view's
    mean colour gap, which one pixel alone does not move."""
    rgb = out["comp_rgb"].clone()
    rgb[..., 0, :, :, :] += 0.05
    return {**out, "comp_rgb": rgb}


def _half_views(out):
    """Renders of the first half of the views stand for the rest."""
    o = dict(out)
    for k in ("comp_rgb", "comp_mask"):
        t = o[k].clone()
        v = t.shape[-3 if k == "comp_mask" else -4]
        idx = [slice(None)] * t.dim()
        src = list(idx)
        axis = t.dim() - (3 if k == "comp_mask" else 4)
        idx[axis] = slice(v // 2, v)
        src[axis] = slice(0, v - v // 2)
        t[tuple(idx)] = t[tuple(src)]
        o[k] = t
    return o


def test_fit_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    rc, last, _ = run_cell(tiny("fit_256_bf16"))
    assert rc == 0 and last["correct"] is False
    assert last["checks"]["change_gap"]["value"] >= 0.99


def test_fit_half_batch(monkeypatch):
    import guassianhand_tpu_torch.train.fit as fit
    orig = fit.compute_error

    def half(pred_rgb, target_rgb, pred_mask, target_mask, *a, **k):
        h = pred_rgb.shape[1] // 2
        return orig(pred_rgb[:, :h], target_rgb[:, :h], pred_mask[:, :h],
                    target_mask[:, :h], *a, **k)

    monkeypatch.setattr(fit, "compute_error", half)
    rc, last, _ = run_cell(tiny("fit_256_bf16"))
    assert rc == 0 and last["correct"] is False


@pytest.mark.parametrize("fault", [_alter_pixel, _half_views],
                         ids=["answer_altered", "half_batch"])
def test_render_faults(monkeypatch, fault):
    import guassianhand_tpu_torch.ops.rasterize as rasterize
    _wrap_output(monkeypatch, rasterize, "rasterize_multiview", fault)
    rc, last, _ = run_cell(tiny("render_100k_8x512"))
    assert rc == 0 and last["correct"] is False


@pytest.mark.parametrize("fault", [_alter_view, _half_views],
                         ids=["answer_altered", "half_batch"])
def test_drive_faults(monkeypatch, fault):
    from guassianhand_tpu_torch.models.one_shot import OneShotAvatarModel
    _wrap_output(monkeypatch, OneShotAvatarModel, "forward",
                 lambda out: fault(out))
    rc, last, _ = run_cell(tiny("drive_8x512_bf16"))
    assert rc == 0 and last["correct"] is False
