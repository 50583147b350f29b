"""A short build-and-check of the projection (K4) and flash-attention (K5)
kernels on one CUDA card, for the first call after either kernel changes:
it builds both sources, prints ptxas' registers and spills, holds each
kernel to its plain twin at random inputs (the bench scene and the edge
scene for K4; L = 15,404, 9,242, 44 and 1 live rows for K5) and times K5
with CUDA events. ``chip_smoke.py`` runs the full checks; this one takes
seconds.

    PYTHONPATH=. python3 tests/torch_kernel_first_check.py
"""
import json
import time

import numpy as np
import torch

from chip_smoke import bf16_ulps, projection_edge_scene
from guassianhand_tpu_torch.core.camera import Camera
from guassianhand_tpu_torch.ops import flash_attention_cuda as fa
from guassianhand_tpu_torch.ops import projection_cuda as pc
from guassianhand_tpu_torch.ops.cuda_build import build_all


def event_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_projection(label, xyz, scaling, rotation, camera):
    xyz, scaling, rotation = (torch.as_tensor(a, device="cuda")
                              for a in (xyz, scaling, rotation))
    cs = pc.camera_consts(camera)
    got = pc.project_forward(xyz, scaling, rotation, cs)
    want = pc.project_plain(xyz, scaling, rotation, cs)
    vis = want[4]
    out = {"label": label, "n": xyz.shape[0], "visible": int(vis.sum()),
           "vis_mismatch": int((got[4] != want[4]).sum()),
           "radius_mismatch": int((got[3] != want[3]).sum())}
    for name, a, b in zip(("mean2d", "depth", "conic"), got[:3], want[:3]):
        out[name] = float((a - b).abs()[vis].max())
    g2 = torch.randn(xyz.shape[0], 2, device="cuda")
    g3 = torch.randn(xyz.shape[0], 3, device="cuda")
    g_got = pc.project_backward(xyz, scaling, rotation, cs, g2, g3)
    g_want = pc.project_adjoint_plain(xyz, scaling, rotation, cs, g2, g3)
    for name, a, b in zip(("gxyz", "gscale", "grot"), g_got, g_want):
        out[name] = float((a - b).abs().max())
        out[name + "_scale"] = float(b.abs().max())
        out[name + "_invisible_nonzero"] = int((a[~vis] != 0).sum())
    print(json.dumps(out))


def check_attention(n, live_share, dtype=torch.float32):
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, dout = (torch.randn(n, 4, 32, generator=g, device="cuda")
                     for _ in range(4))
    live = (torch.rand(n, generator=g, device="cuda") < live_share
            ).nonzero()[:, 0]
    q, k, v, dout = (t[live].to(dtype).contiguous()
                     for t in (q, k, v, dout))
    out, lse = fa.flash_forward(q, k, v)
    out_p, lse_p = fa.flash_attention_plain(q, k, v)
    delta = fa.attention_delta(out, dout)
    dk, dv = fa.flash_backward_dkv(q, k, v, dout, lse, delta)
    dq = fa.flash_backward_dq(q, k, v, dout, lse, delta)
    want = fa.flash_attention_backward_plain(q, k, v, out_p, lse_p, dout)
    torch.cuda.synchronize()
    row = {"n": n, "L": live.numel(), "dtype": str(dtype),
           "out": float((out.float() - out_p.float()).abs().max()),
           "lse": float((lse - lse_p).abs().max())}
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv),
                          (out_p, *want)):
        if name != "out":
            row[name] = float((a.float() - b.float()).abs().max())
            row[name + "_scale"] = float(b.abs().max())
        if dtype == torch.bfloat16:
            row[name + "_ulps"] = float(bf16_ulps(a, b).max())
    if n > 1000:
        row["fwd_ms"] = event_ms(lambda: fa.flash_forward(q, k, v))
        row["dkv_ms"] = event_ms(lambda: fa.flash_backward_dkv(
            q, k, v, dout, lse, delta))
        row["dq_ms"] = event_ms(lambda: fa.flash_backward_dq(
            q, k, v, dout, lse, delta))
        row["plain_fwd_ms"] = event_ms(
            lambda: fa.flash_attention_plain(q, k, v), 2)
    print(json.dumps(row))


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    texts = build_all([pc.LIB, fa.LIB, fa.LIB_BF16])
    print("build seconds", time.time() - t0)
    for name, text in texts.items():
        print(name, [ln.strip() for ln in text.splitlines()
                     if "registers" in ln or "spill" in ln
                     or "wgmma" in ln])
    rng = np.random.RandomState(0)
    n = 49152
    xyz = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scaling = rng.uniform(0.002, 0.01, (n, 3)).astype(np.float32)
    f = 1.1 * 512
    K = np.array([[f, 0, 256], [0, f, 256], [0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 1.8
    check_projection("bench", xyz, scaling, q,
                     Camera.from_w2c(w2c, K, 512, 512, device="cuda"))
    xyz, scaling, rotation, w2c, K, h, w = projection_edge_scene()
    check_projection("edge", xyz, scaling, rotation,
                     Camera.from_w2c(w2c, K, h, w, device="cuda"))
    for dtype in (torch.float32, torch.bfloat16):
        for n, live_share in ((15404, 1.0), (15404, 0.6), (77, 0.5),
                              (1, 1.0)):
            check_attention(n, live_share, dtype)
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
