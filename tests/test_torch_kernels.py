"""The port's PMVO kernels (monohair_tpu_torch/ops/patch_kernels.py) against the
JAX package's: the plain PyTorch versions vs the plain-XLA references and the
Pallas kernels in interpret mode, on the same numpy inputs. The CUDA kernels
themselves are compared with the plain versions on the card by chip_smoke.py
and by the gpu-marked tests below."""

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monohair_tpu.ops.pallas_kernels import (patch_gather_dma, patch_gather_reference,
                                             patch_min_loss_fused,
                                             patch_min_loss_reference)
from monohair_tpu_torch.ops import patch_kernels as pk

torch.set_num_threads(1)

# sums over views are taken in another order by each implementation
RTOL, ATOL = 1e-5, 1e-6


def gather_case(rng, V, H, W, N, patch, C=8):
    half = patch // 2
    maps = rng.normal(size=(V, H, W, C)).astype(np.float32)
    padded = np.pad(maps, ((0, 0), (half, half), (half, half), (0, 0)), mode="edge")
    rc = np.stack([rng.integers(0, H, (V, N)), rng.integers(0, W, (V, N))],
                  -1).astype(np.int32)
    rc[:, :4] = [[0, 0], [H - 1, W - 1], [0, W - 1], [H - 1, 0]]  # all four corners
    rc[:, 4:8] = [[0, W // 2], [H - 1, W // 2], [H // 2, 0], [H // 2, W - 1]]  # edges
    return padded, rc


@pytest.mark.parametrize("V,H,W,N,patch", [(3, 20, 17, 70, 5), (2, 11, 13, 40, 3),
                                           (2, 16, 9, 33, 7)])
def test_patch_gather_plain_bit_exact(V, H, W, N, patch):
    rng = np.random.default_rng(patch)
    padded, rc = gather_case(rng, V, H, W, N, patch)
    ref = np.asarray(patch_gather_reference(jnp.asarray(padded), jnp.asarray(rc), patch))
    dma = np.asarray(patch_gather_dma(jnp.asarray(padded), jnp.asarray(rc), patch,
                                      tile_n=16, interpret=True))
    ours = pk.patch_gather(torch.from_numpy(padded), torch.from_numpy(rc), patch)
    assert ours.shape == (V, N, patch * patch, 8)
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ours.numpy(), dma)


def min_loss_case(rng, kind, V=4, N=10, S=24, P=9):
    prj = rng.normal(size=(V, N, S, 2)).astype(np.float32)
    ori = rng.normal(size=(V, N, P, 2)).astype(np.float32)
    conf = rng.random((V, N, P)).astype(np.float32)
    vis = np.where(rng.random((V, N)) > 0.3, rng.random((V, N)), -1.0).astype(np.float32)
    thr = 0.4
    if kind == "tied_taps":
        # every tap of half the windows equals tap 0 (or its negation): the
        # strict < keeps the first
        ori[:, ::2] = ori[:, ::2, :1] * np.where(rng.random((V, N // 2 + N % 2, P, 1)) > 0.5,
                                                 1.0, -1.0).astype(np.float32)
        ori[:, 1::3, 3:6] = ori[:, 1::3, 2:3]
    elif kind == "all_invisible":
        vis[:, ::2] = -1.0
        vis[:] = np.where(rng.random((V, N)) > 0.5, vis, -1.0)
        vis[:, 0] = -1.0
    elif kind == "high_conf":
        # some windows entirely below the threshold, some with a single tap above
        conf = (conf * 0.3).astype(np.float32)
        conf[:, ::3, 4] = 0.9
        conf[1, :, :] = 0.35
        conf[2, :, 0] = 0.41
    elif kind == "zero_vectors":
        ori[:, :, ::4] = 0.0
        prj[:, ::3, ::5] = 0.0
    elif kind == "tiny_vectors":
        # |o||d| under the 1e-8 clamp, and directions too short to normalise
        ori[:, :, ::3] *= np.float32(1e-9)
        prj[:, ::4, ::5] *= np.float32(1e-6)
    elif kind == "repeat_runs":
        # runs of equal taps whose confidences cross the threshold
        ori[:, :, 1:5] = ori[:, :, :1]
        ori[:, :, 6:9] = ori[:, :, 5:6]
        conf[:, ::2, 1:9:2] = 0.1
        conf[:, 1::2, 2:9:2] = 0.1
    elif kind == "near_ties":
        # the taps of every other window are tap 0 moved by 1-3 ulps in each
        # component: rounded quotients tie where the exact ones do not. They
        # share tap 0's confidence: XLA rounds |o| and o.d otherwise than
        # PyTorch on the CPU, so the JAX functions may keep another of the
        # nearly tied taps, which then moves the sums by ulps only
        conf[:, 1::2] = conf[:, 1::2, :1]
        taps = np.broadcast_to(ori[:, 1::2, :1], ori[:, 1::2].shape).copy()
        steps = rng.integers(1, 4, taps.shape)
        toward = np.where(rng.random(taps.shape) > 0.5, np.inf, -np.inf).astype(np.float32)
        for i in range(3):
            taps = np.where(i < steps, np.nextafter(taps, toward), taps).astype(np.float32)
        ori[:, 1::2, 1:] = taps[:, :, 1:]
    return prj, ori, conf, vis, thr


@pytest.mark.parametrize("kind,S", [("random", 24), ("tied_taps", 24),
                                    ("all_invisible", 24), ("high_conf", 24),
                                    ("zero_vectors", 24), ("random", 1),
                                    ("high_conf", 1), ("near_ties", 24)])
def test_patch_min_loss_plain_matches_reference_and_pallas(kind, S):
    rng = np.random.default_rng(len(kind) * 10 + S)
    prj, ori, conf, vis, thr = min_loss_case(rng, kind, S=S)
    ref = patch_min_loss_reference(*map(jnp.asarray, (prj, ori, conf, vis)), thr)
    fused = patch_min_loss_fused(*map(jnp.asarray, (prj, ori, conf, vis)), thr,
                                 interpret=True)
    ours = pk.patch_min_loss(*map(torch.from_numpy, (prj, ori, conf, vis)), thr)
    for other in (ref, fused):
        for a, b in zip(ours[:2], other[:2]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(ours[2].numpy(), np.asarray(other[2]))
    if kind == "all_invisible":
        assert (ours[2].numpy()[0] == 0).all() and (ours[1].numpy()[0] == 0).all()


def tap_loop_emulation(prj, ori, conf, vis, thr):
    """One thread of the CUDA tap loop (csrc/patch_kernels.cu) in torch f32,
    over every (v, n, s) at once, beside the plain version's own loop.

    The kernel stages |o| once per (v, n, p) and the window's high-confidence
    flag once per (v, n). It skips the taps after tap 0 whose o is (0, 0) or
    equals the previous tap's o when that tap was compared. Per tap it holds
    the best tap's a_b = |o.d| and b_b = max(|o||d|, 1e-8) against the tap's
    (a, b): fl(a * b_b) < fl(a_b * b) skips the tap, fl(fl(a - 2^-20 b) * b_b)
    > fl(a_b * b) takes it, and only the rest (near ties, NaN) divide and
    compare the rounded losses.
    Returns ((min_loss, best_conf, tap) of the emulation, the same of the plain
    loop, the view-order sums of the emulation, the share of steps on the
    exact path, and the number of steps decided without dividing against the
    plain loop's choice)."""
    dx, dy = prj[..., 0], prj[..., 1]
    dn = torch.sqrt(dx * dx + dy * dy)
    ox, oy = ori[..., 0], ori[..., 1]
    on = torch.sqrt(ox * ox + oy * oy)
    hc = (conf > thr).any(-1)[..., None]

    def terms(p):
        a = torch.abs(ox[:, :, p, None] * dx + oy[:, :, p, None] * dy)
        return a, torch.clamp_min(on[:, :, p, None] * dn, 1e-8)

    a_b, b_b = terms(0)
    loss_b = 1.0 - a_b / b_b
    conf_b = conf[:, :, :1].expand_as(loss_b)
    tap_b = torch.zeros_like(loss_b, dtype=torch.long)
    plain = [loss_b, conf_b, tap_b]
    exact_steps, wrong = 0, 0
    compared = torch.ones_like(hc)             # tap p - 1 was compared with the best
    for p in range(1, ori.shape[2]):
        a, b = terms(p)
        loss = 1.0 - a / b
        c = conf[:, :, p, None].expand_as(loss)
        eligible = ~hc | (c > thr)
        take_plain = eligible & (loss < plain[0])
        plain = [torch.where(take_plain, new, old)
                 for new, old in zip((loss, c, torch.full_like(tap_b, p)), plain)]
        zero = ((ox[:, :, p] == 0) & (oy[:, :, p] == 0))[..., None]
        repeat = ((ox[:, :, p] == ox[:, :, p - 1]) & (oy[:, :, p] == oy[:, :, p - 1]))[..., None]
        never = zero | (repeat & compared)
        compared = eligible
        x, y = a * b_b, a_b * b
        sure = eligible & ~never & ((a - 2.0 ** -20 * b) * b_b > y)
        exact = eligible & ~never & ~sure & ~(x < y)
        take = sure | (exact & ~((a == a_b) & (b == b_b)) & (loss < loss_b))
        exact_steps += int(exact.sum())
        wrong += int((eligible & ~exact & (sure != take_plain)).sum())
        loss_b, a_b, b_b, conf_b = (torch.where(take, new, old) for new, old in
                                    zip((loss, a, b, c), (loss_b, a_b, b_b, conf_b)))
        tap_b = torch.where(take, p, tap_b)
    w = torch.where(vis[:, :, None] == -1.0, 0.0, 1.0) * conf_b
    sums = [torch.zeros_like(loss_b[0]) for _ in range(3)]
    for v in range(w.shape[0]):                       # in view order, as the kernel
        sums = [sums[0] + w[v] * loss_b[v], sums[1] + w[v], sums[2] + (w[v] > 0).float()]
    share = exact_steps / loss_b.numel() / (ori.shape[2] - 1)
    return (loss_b, conf_b, tap_b), plain, sums, share, wrong


@pytest.mark.parametrize("kind,S", [("random", 24), ("tied_taps", 24), ("high_conf", 24),
                                    ("zero_vectors", 24), ("tiny_vectors", 24),
                                    ("repeat_runs", 24), ("near_ties", 24), ("random", 1),
                                    ("tied_taps", 1), ("high_conf", 1), ("zero_vectors", 1),
                                    ("tiny_vectors", 1), ("repeat_runs", 1),
                                    ("near_ties", 1)])
def test_tap_loop_skip_rule_takes_the_plain_versions_taps(kind, S):
    rng = np.random.default_rng(len(kind) * 7 + S)
    *arrays, thr = min_loss_case(rng, kind, S=S, P=49)
    prj, ori, conf, vis = map(torch.from_numpy, arrays)
    ours, plain, sums, share, wrong = tap_loop_emulation(prj, ori, conf, vis, thr)
    assert wrong == 0
    assert torch.equal(ours[2], plain[2])
    assert torch.equal(ours[0], plain[0]) and torch.equal(ours[1], plain[1])
    # the plain loop above is patch_min_loss_plain's: same weights, same sums
    w = torch.where(vis[:, :, None] == -1.0, 0.0, 1.0) * plain[1]
    ref = pk.patch_min_loss_plain(prj, ori, conf, vis, thr)
    assert torch.equal(ref[0], torch.sum(w * plain[0], 0))
    assert torch.equal(ref[1], torch.sum(w, 0))
    for a, b in zip(sums[:2], ref[:2]):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    assert torch.equal(sums[2], ref[2])
    print(f"{kind} S={S}: {share:.4f} of the steps on the exact path")
    if kind == "random":
        assert share < 0.01, share       # the rule decides almost every step


def test_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.default_rng(0)
    pk.reset_launch_counts()
    padded, rc = gather_case(rng, 2, 9, 10, 12, 3)
    pk.patch_gather(torch.from_numpy(padded), torch.from_numpy(rc), 3)
    pk.patch_gather(torch.from_numpy(padded).bfloat16(), torch.from_numpy(rc), 3)
    prj, ori, conf, vis, thr = min_loss_case(rng, "random")
    pk.patch_min_loss(*map(torch.from_numpy, (prj, ori, conf, vis)), thr)
    assert pk.LAUNCHES == {"patch_gather": 0, "patch_gather_bf16": 0, "patch_min_loss": 0}


def test_other_devices_raise():
    x = torch.empty((2, 5, 5, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pk.patch_gather(x, torch.empty((2, 3, 2), dtype=torch.int32, device="meta"), 3)
    with pytest.raises(ValueError, match="unsupported device"):
        pk.patch_min_loss(torch.empty((2, 3, 4, 2), device="meta"),
                          torch.empty((2, 3, 9, 2), device="meta"),
                          torch.empty((2, 3, 9), device="meta"),
                          torch.empty((2, 3), device="meta"), 0.4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_patch_gather_bit_exact(cuda_device):
    rng = np.random.default_rng(1)
    padded, rc = gather_case(rng, 4, 64, 48, 500, 7)
    p, r = torch.from_numpy(padded).to(cuda_device), torch.from_numpy(rc).to(cuda_device)
    before = pk.LAUNCHES["patch_gather"]
    out = pk.patch_gather(p, r, 7)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["patch_gather"] == before + 1
    assert torch.equal(out, pk.patch_gather_plain(p, r, 7))


@pytest.mark.gpu
def test_cuda_patch_gather_bf16_bit_exact(cuda_device):
    rng = np.random.default_rng(1)
    padded, rc = gather_case(rng, 4, 64, 48, 500, 7)
    p = torch.from_numpy(padded).to(cuda_device).bfloat16()
    r = torch.from_numpy(rc).to(cuda_device)
    before = pk.LAUNCHES["patch_gather_bf16"]
    out = pk.patch_gather(p, r, 7)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["patch_gather_bf16"] == before + 1 and out.dtype == torch.float32
    assert torch.equal(out.view(torch.int32), pk.patch_gather_plain(p, r, 7).view(torch.int32))
    with pytest.raises(TypeError, match="f32 or bf16"):
        pk.patch_gather(p.half(), r, 7)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,S", [("random", 90), ("tied_taps", 24), ("high_conf", 1)])
def test_cuda_patch_min_loss_matches_plain(cuda_device, kind, S):
    rng = np.random.default_rng(2)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in min_loss_case(rng, kind, V=8, N=300, S=S, P=49)[:4]]
    k = pk.patch_min_loss(*args, 0.4)
    p = pk.patch_min_loss_plain(*args, 0.4)
    torch.cuda.synchronize()
    for a, b in zip(k[:2], p[:2]):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    assert torch.equal(k[2], p[2])
