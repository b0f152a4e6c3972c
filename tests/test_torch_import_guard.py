"""The port and chip_smoke.py import nothing the GPU machine lacks.

In a fresh interpreter whose import system refuses jax, jaxlib, flax, optax,
cv2, yaml, PIL, monohair_tpu, tools and tests, every module of monohair_tpu_torch and chip_smoke.py
import, chip_smoke's stage phase runs on the CPU at a small size, and
`python -m monohair_tpu_torch.HairGrow --yaml=<case> --device=cpu` writes the
stage's files on a small written case, as do PMVO and then
`python -m monohair_tpu_torch.infer_inner` on another, and
`python -m monohair_tpu_torch.prepare_data` on a small capture case, once with
the NeRF off, once with it on at a tiny budget, once with the bust fit on
(the synthetic SMPL-X, a few steps), and once on JPEG frames (the port's
codec, its library built into build/); `python -m monohair_tpu_torch.train_mvs`
trains a few steps on a small written case and resumes,
`python -m monohair_tpu_torch.run_pipeline` runs the four stages on a small
synthwig case, PMVO runs with bf16 maps on a mesh of two CPU shards beside
the debug exports, `python -m monohair_tpu_torch.segment.convert` writes
a public-named FAN checkpoint as a flax tree, and the mp4v codec writes and
reads a video, from which extract_sharpest_frames keeps its frames, as it
does from an H.264 stream of the port's test-stream writer rotated by 90
degrees, and
writes a small NeRF fly-through, and `python -m
monohair_tpu_torch.train_hair_parser` draws its frames, trains both nets a
few steps at a tiny size and writes its four files."""

import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARDED = textwrap.dedent('''
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "cv2", "yaml", "PIL", "monohair_tpu", "tools",
               "tests")

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"import of {name} refused")
            return None

    sys.meta_path.insert(0, Refuse())
    import torch
    torch.set_num_threads(1)
    import monohair_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(monohair_tpu_torch.__path__,
                                                   "monohair_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    result = chip_smoke.phase_stage("cpu", num_views=12)
    assert result["median_cos"] > 0.95, result

    # the HairGrow CLI, as `python -m` runs it, on grids of the voxelised wig
    import os, runpy, tempfile
    import numpy as np
    from monohair_tpu_torch.io.hair_io import load_hair
    from monohair_tpu_torch.io.image_io import read_png
    from monohair_tpu_torch.io.mat_io import save_occ_ori_mat
    from monohair_tpu_torch.io.yaml_io import dump_yaml
    from monohair_tpu_torch.synthetic import make_wig, wig_grids, write_synthwig_case
    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_synthwig_case(tmp, num_views=2)
        refine = os.path.join(tmp, "synthwig", "output", "verify", "refine")
        save_occ_ori_mat(refine, *wig_grids(make_wig(rng=np.random.default_rng(0))))
        with open(os.path.join(tmp, "case.yaml"), "w") as f:
            f.write(dump_yaml(cfg.to_dict()))
        sys.argv = ["HairGrow", "--yaml=" + os.path.join(tmp, "case"), "--device=cpu"]
        runpy.run_module("monohair_tpu_torch.HairGrow", run_name="__main__")
        for name in ("scalp_segment.hair", "scalp_segment_smooth.hair", "strands.hair",
                     "connected_strands.hair"):
            segments, points = load_hair(os.path.join(refine, name))
            assert len(segments) > 100 and np.isfinite(points).all(), name
        assert int(np.load(os.path.join(refine, "num_root.npy"))) > 0

    # PMVO then the infer_inner CLI, as `python -m` runs them, on a 4-view case
    # (random full-width nets: the case names no weights that exist)
    from monohair_tpu_torch.io.voxels_io import load_voxels_dat
    from monohair_tpu_torch.io.mat_io import load_occ_mat
    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_synthwig_case(tmp, num_views=4)
        cfg.infer_inner["render_size"] = [48, 40]
        cfg.mvs.update(eval_vsize=0.08, eval_batch=512)
        with open(os.path.join(tmp, "case.yaml"), "w") as f:
            f.write(dump_yaml(cfg.to_dict()))
        for cli in ("PMVO", "infer_inner"):
            sys.argv = [cli, "--yaml=" + os.path.join(tmp, "case"), "--device=cpu"]
            runpy.run_module("monohair_tpu_torch." + cli, run_name="__main__")
        case = os.path.join(tmp, "synthwig")
        for view in ("000", "003"):
            for name in ("bust_depth", "undirectional_map", "mask", "hair_depth"):
                assert os.path.exists(os.path.join(case, "imgs", view, name + ".png"))
        raw = np.load(os.path.join(case, "ours", "raw.npy"))
        assert raw.shape[1] == 7 and len(raw) > 100 and np.isfinite(raw).all()
        assert len(load_voxels_dat(os.path.join(case, "ours", "voxels.dat"))[0]) == raw[:, 6].sum()
        assert load_occ_mat(os.path.join(case, "ours/Voxel_hair/Occ3D.mat")).sum() <= raw[:, 6].sum()
        assert load_occ_mat(os.path.join(case, "output/verify/full/Occ3D.mat")).sum() > 100

    # the prepare_data CLI (stage 1's image half) on a 4-frame capture case,
    # classical masks (no weights named), the NeRF and bust fit switched off
    with tempfile.TemporaryDirectory() as tmp:
        from monohair_tpu_torch.synthetic import write_capture_case
        cfg = write_capture_case(tmp, "cap", num_frames=4, H=48, W=64)["config"]
        with open(os.path.join(tmp, "case.yaml"), "w") as f:
            f.write(dump_yaml(cfg.to_dict()))
        sys.argv = ["prepare_data", "--yaml=" + os.path.join(tmp, "case"), "--device=cpu",
                    "--prepare_data.run_ngp=", "--prepare_data.fit_bust="]
        runpy.run_module("monohair_tpu_torch.prepare_data", run_name="__main__")
        case = os.path.join(tmp, "cap")
        for sub in ("capture_images", "hair_mask", "mask", "mask_hair", "best_ori", "conf", "Ori"):
            assert sorted(os.listdir(os.path.join(case, sub))) == ["frame_0001.png",
                                                                   "frame_0003.png"], sub
        assert np.load(os.path.join(case, "render_depth", "frame_0001.npy")).shape == (48, 64, 3)
        assert os.path.exists(os.path.join(case, "imgs", "001", "bust_hair_depth.png"))

    # the prepare_data CLI with the NeRF on at a tiny budget (full-width
    # Fourier field, 3 steps), the steps after it off
    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_capture_case(tmp, "cap", num_frames=4, H=24, W=32)["config"]
        cfg.ngp.update(train_steps=3, rays_per_batch=64, mesh_resolution=12,
                       marching_cubes_density_thresh=1.0)
        cfg.infer_inner["render_size"] = [16, 8]
        with open(os.path.join(tmp, "case.yaml"), "w") as f:
            f.write(dump_yaml(cfg.to_dict()))
        sys.argv = ["prepare_data", "--yaml=" + os.path.join(tmp, "case"), "--device=cpu",
                    "--prepare_data.run_ngp", "--prepare_data.fit_bust=",
                    "--prepare_data.process_bust=", "--prepare_data.render_depth=",
                    "--prepare_data.process_imgs=", "--ngp.train_steps=4"]
        runpy.run_module("monohair_tpu_torch.prepare_data", run_name="__main__")
        from monohair_tpu_torch.io.mesh_io import load_obj
        case = os.path.join(tmp, "cap")
        for view in ("000", "001"):
            shot = read_png(os.path.join(case, "trainning_images", "capture_images", view + ".png"))
            assert shot.shape == (16, 8, 3), shot.shape
            assert os.path.exists(os.path.join(case, "imgs", view, "origin.png"))
        nerf_v, nerf_f = load_obj(os.path.join(case, "colmap", "base.obj"))
        mvs_v, mvs_f = load_obj(os.path.join(case, "ours", "colmap_points.obj"))
        assert len(nerf_v) == len(mvs_v) and np.array_equal(nerf_f, mvs_f)

    # the prepare_data CLI with the bust fit on (3 steps) on a 4-frame capture
    # case with the synthetic SMPL-X at its small sizes and annotations from truth
    with tempfile.TemporaryDirectory() as tmp:
        from monohair_tpu_torch.synthetic import SMPLX_SMALL, write_bust_fit_assets
        out = write_capture_case(tmp, "cap", num_frames=4, H=24, W=32)
        cfg = out["config"]
        write_bust_fit_assets(os.path.join(tmp, "cap"), cfg, out["mvs_poses"], 24, 32,
                              sizes=SMPLX_SMALL, iters=3)
        with open(os.path.join(tmp, "case.yaml"), "w") as f:
            f.write(dump_yaml(cfg.to_dict()))
        sys.argv = ["prepare_data", "--yaml=" + os.path.join(tmp, "case"), "--device=cpu",
                    "--prepare_data.run_ngp=", "--prepare_data.fit_bust",
                    "--prepare_data.render_depth=", "--prepare_data.process_imgs="]
        runpy.run_module("monohair_tpu_torch.prepare_data", run_name="__main__")
        case = os.path.join(tmp, "cap")
        for name in ("model_tsfm.dat", "model_tsfm_semantic.dat", "optimize/final_template.obj",
                     "optimize/fit_losses.txt", "Bust/bust_long.obj", "Bust/flame_bust.obj",
                     "Bust/scalp.obj", "ours/bust_long_tsfm.obj"):
            assert os.path.getsize(os.path.join(case, name)) > 0, name
        assert np.isfinite(np.fromfile(os.path.join(case, "model_tsfm.dat"), np.float32)).all()

    # the train_mvs CLI, as `python -m` runs it, on a 2-view 16x16 case written
    # with the port's writers, then --resume
    with tempfile.TemporaryDirectory() as tmp:
        from monohair_tpu_torch.io.cameras_io import save_cam_params
        from monohair_tpu_torch.io.image_io import write_png
        from monohair_tpu_torch.synthetic import cameras_numpy, ring_camera_list
        rng = np.random.default_rng(0)
        cam_list = ring_camera_list(2)
        ndc, w2c = cameras_numpy(cam_list)
        save_cam_params(os.path.join(tmp, "cam_params.json"), [c["file"] for c in cam_list],
                        ndc, np.linalg.inv(w2c))
        for c in cam_list:
            vd = os.path.join(tmp, "data", "caseA", "imgs", c["file"])
            os.makedirs(vd)
            write_png(os.path.join(vd, "undirectional_map.png"),
                      rng.integers(0, 255, (16, 16, 3), dtype=np.uint8))
            for n in ("hair_depth", "bust_depth", "mask"):
                write_png(os.path.join(vd, n + ".png"),
                          rng.integers(0, 255, (16, 16), dtype=np.uint8))
        occ = np.zeros((32, 32, 24), np.float32)
        occ[10:20, 10:20, 8:16] = 1.0
        ori = np.zeros((32, 32, 24, 3), np.float32)
        ori[..., 1] = occ
        save_occ_ori_mat(os.path.join(tmp, "data", "caseA", "ours"), occ, ori)
        out = os.path.join(tmp, "ckpt")
        for steps, extra in ((3, []), (5, ["--resume"])):
            sys.argv = ["train_mvs", "--data_root=" + os.path.join(tmp, "data"),
                        "--calib=" + os.path.join(tmp, "cam_params.json"), "--kind=occ",
                        "--batch=32", "--eval_every=2", "--save_every=100",
                        f"--steps={steps}", "--out=" + out, "--device=cpu"] + extra
            runpy.run_module("monohair_tpu_torch.train_mvs", run_name="__main__")
        stats = np.loadtxt(os.path.join(out, "stats_occ.txt"), ndmin=2)
        assert stats.shape == (3, 6) and np.isfinite(stats).all(), stats
        assert int(np.load(os.path.join(out, "occ_train.npz"))["step"]) == 5

    # the run_pipeline CLI, as `python -m` runs it, on a 4-view synthwig case
    # (prepare_data's steps off, random full-width nets, fused into full/)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_synthwig_case(tmp, num_views=4)
        cfg["prepare_data"] = dict.fromkeys(("select_images", "process_camera", "run_ngp",
                                             "fit_bust", "process_bust", "render_depth",
                                             "process_imgs"), False)
        cfg.PMVO["infer_inner"] = True
        cfg.infer_inner["render_size"] = [48, 40]
        cfg.mvs.update(eval_vsize=0.08, eval_batch=512)
        with open(os.path.join(tmp, "case.yaml"), "w") as f:
            f.write(dump_yaml(cfg.to_dict()))
        sys.argv = ["run_pipeline", "--yaml=" + os.path.join(tmp, "case"), "--device=cpu"]
        runpy.run_module("monohair_tpu_torch.run_pipeline", run_name="__main__")
        full = os.path.join(tmp, "synthwig", "output", "verify", "full")
        segments, points = load_hair(os.path.join(full, "connected_strands.hair"))
        assert len(segments) > 100 and np.isfinite(points).all()
        with open(os.path.join(tmp, "synthwig", "output", "verify", "metrics.jsonl")) as f:
            assert len(f.readlines()) == 4

    # a JPEG capture (frames written by the port's encoder) through the
    # prepare_data CLI's image half: best_ori/, conf/, Ori/ and the masks are
    # JPEG under the frames' names, beside the render_depth/<view>.JPG preview;
    # the codec's library is built into the git-ignored build/ tree
    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_capture_case(tmp, "cap", num_frames=4, H=48, W=64, ext=".JPG")["config"]
        with open(os.path.join(tmp, "case.yaml"), "w") as f:
            f.write(dump_yaml(cfg.to_dict()))
        sys.argv = ["prepare_data", "--yaml=" + os.path.join(tmp, "case"), "--device=cpu",
                    "--prepare_data.run_ngp=", "--prepare_data.fit_bust="]
        runpy.run_module("monohair_tpu_torch.prepare_data", run_name="__main__")
        case = os.path.join(tmp, "cap")
        for sub in ("capture_images", "hair_mask", "mask", "mask_hair", "best_ori", "conf", "Ori"):
            files = sorted(os.listdir(os.path.join(case, sub)))
            assert files == ["frame_0001.JPG", "frame_0003.JPG"], (sub, files)
            with open(os.path.join(case, sub, files[0]), "rb") as f:
                assert f.read(2) == b"\\xff\\xd8", sub
        assert os.path.exists(os.path.join(case, "render_depth", "frame_0001.JPG"))
    from monohair_tpu_torch.ops import _build
    assert _build.BUILD_INFO["jpeg.cpp"]["path"].startswith(
        os.path.join(os.getcwd(), "build", "monohair_tpu_torch") + os.sep)

    # PMVO with bf16 maps on a mesh of two CPU shards, the debug exports
    from monohair_tpu_torch.pipeline.common import case_paths
    from monohair_tpu_torch.pipeline.pmvo_stage import run_pmvo
    from monohair_tpu_torch.visualization import save_occ_slices, save_oriented_points
    with tempfile.TemporaryDirectory() as tmp:
        cfg = case_paths(write_synthwig_case(tmp, num_views=4))
        cfg.PMVO["bf16_maps"] = True
        run_pmvo(cfg, device="cpu", mesh=(torch.device("cpu"),) * 2)
        occ = load_occ_mat(os.path.join(tmp, "synthwig/output/verify/refine/Occ3D.mat"))
        assert occ.sum() > 100
        save_occ_slices(os.path.join(tmp, "occ"), occ, num=2)
        assert read_png(os.path.join(tmp, "occ_slice1.png")).shape == occ.shape[:2]
        save_oriented_points(os.path.join(tmp, "p.ply"), np.zeros((3, 3)), np.ones((3, 3)))

    # the checkpoint converter, as `python -m` runs it, on a public-named FAN
    with tempfile.TemporaryDirectory() as tmp:
        from monohair_tpu_torch.segment.convert import load_flax_npz
        from monohair_tpu_torch.segment.fan import FAN
        net = FAN(num_modules=1, depth=1, width=0.125)
        public = {"module." + k.replace("down_bn.", "downsample.0.").replace(
            "down_conv.", "downsample.2."): v for k, v in net.state_dict().items()}
        torch.save(public, os.path.join(tmp, "fan.pth"))
        sys.argv = ["convert", "--net", "fan", "--ckpt", os.path.join(tmp, "fan.pth"),
                    "--out", os.path.join(tmp, "fan.npz")]
        runpy.run_module("monohair_tpu_torch.segment.convert", run_name="__main__")
        back = load_flax_npz(FAN(num_modules=1, depth=1, width=0.125), os.path.join(tmp, "fan.npz"))
        for k, v in net.state_dict().items():
            assert torch.equal(back.state_dict()[k], v), k

    # video in and out: the port's mp4v writer and reader, the sharpest-frame
    # extraction and a small fly-through (the codec's library built into build/)
    with tempfile.TemporaryDirectory() as tmp:
        from monohair_tpu_torch.coords import nerf_to_ngp
        from monohair_tpu_torch.io.video import VideoWriter, read_video, video_info
        from monohair_tpu_torch.nerf.fourier import FourierField
        from monohair_tpu_torch.nerf.pipeline import render_camera_path_video
        from monohair_tpu_torch.nerf.poses import _se3, save_base_cam
        from monohair_tpu_torch.video import extract_sharpest_frames
        rng = np.random.default_rng(0)
        path = os.path.join(tmp, "v.mp4")
        with VideoWriter(path, 10, (32, 24)) as writer:
            for i in range(6):
                writer.write(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8) if i in (1, 4)
                             else np.full((24, 32, 3), 128, np.uint8))
        assert video_info(path) == (6, 10.0, 32, 24)
        assert len(list(read_video(path))) == 6
        kept = extract_sharpest_frames(path, os.path.join(tmp, "frames"), interval=3,
                                       device="cpu")
        assert kept == ["frame_00000.png", "frame_00001.png"], kept
        from monohair_tpu_torch.io.h264_streams import write_frames
        h264 = os.path.join(tmp, "v264.mp4")
        write_frames(h264, [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8) if i in (1, 4)
                            else np.full((24, 32, 3), 128, np.uint8) for i in range(6)],
                     fps=10, rotation=90)
        assert video_info(h264) == (6, 10.0, 24, 32)
        kept = extract_sharpest_frames(h264, os.path.join(tmp, "frames264"), interval=3,
                                       device="cpu")
        assert kept == ["frame_00000.png", "frame_00001.png"], kept
        from monohair_tpu_torch.io import hevc_streams
        hevc = os.path.join(tmp, "v265.mp4")
        hevc_streams.write_frames(hevc, [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
                                         if i in (1, 4) else np.full((24, 32, 3), 128, np.uint8)
                                         for i in range(6)], fps=10, ctb=16, rotation=90)
        assert video_info(hevc) == (6, 10.0, 24, 32)
        kept = extract_sharpest_frames(hevc, os.path.join(tmp, "frames265"), interval=3,
                                       device="cpu")
        assert kept == ["frame_00000.png", "frame_00001.png"], kept
        c2w = [np.eye(4), np.eye(4)]
        c2w[1][:3, 3] = [0.1, 0.0, 0.0]
        save_base_cam(os.path.join(tmp, "base_cam.json"),
                      [_se3(m[:, :3], m[:, 3]) for m in map(nerf_to_ngp, c2w)], [40.0, 40.0])
        field = FourierField(num_features=8, hidden=8, depth=2, geo_feat=3,
                             generator=torch.Generator().manual_seed(0), device="cpu")
        out = os.path.join(tmp, "fly.mp4")
        assert render_camera_path_video(field, os.path.join(tmp, "base_cam.json"), out,
                                        H=8, W=16, frames_per_seg=2) == 2
        assert video_info(out) == (2, 24.0, 16, 8)
    for source in ("mp4v.cpp", "h264.cpp", "h264_writer.cpp", "hevc.cpp", "hevc_writer.cpp"):
        assert _build.BUILD_INFO[source]["path"].startswith(
            os.path.join(os.getcwd(), "build", "monohair_tpu_torch") + os.sep)

    # the train_hair_parser CLI, as `python -m` runs it: 2 + 1 frames of 32x32,
    # both nets at width 0.125 for 2 steps, evaluated through the runners
    from monohair_tpu_torch.segment import frames as seg_frames
    seg_frames.FRAME_SIZE = 32
    with tempfile.TemporaryDirectory() as tmp:
        sys.argv = ["train_hair_parser", "--device=cpu", "--width=0.125", "--steps=2",
                    "--modnet_steps=2", "--n_train=2", "--n_eval=1", "--out=" + tmp]
        runpy.run_module("monohair_tpu_torch.train_hair_parser", run_name="__main__")
        assert sorted(os.listdir(tmp)) == ["bisenet.npz", "meta.json", "modnet.npz",
                                           "stats.txt"], os.listdir(tmp)
        with open(os.path.join(tmp, "stats.txt")) as f:
            assert f.read().splitlines()[2] == "steps 2 width 0.125 train 2 eval 1"

    loaded = sorted(m for m in sys.modules if blocked(m))
    assert not loaded, loaded
    print("GUARD_OK", len(names))
''')


def test_port_and_chip_smoke_need_no_jax_cv2_yaml_pil():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", GUARDED], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "GUARD_OK" in proc.stdout
    modules = int(proc.stdout.split("GUARD_OK")[1].split()[0])
    assert modules >= 20


TOOL_GUARDED = textwrap.dedent('''
    import importlib.abc, json, os, runpy, sys, tempfile

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "cv2", "yaml", "PIL", "monohair_tpu", "tools",
               "tests")

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"import of {name} refused")
            return None

    sys.meta_path.insert(0, Refuse())
    tool = runpy.run_path(os.path.join("tools", "run_capture_case.py"), run_name="tool")
    with tempfile.TemporaryDirectory() as tmp:
        # the whole pipeline on the CPU: 8 frames at 96x128 (4 views: random
        # MVS nets, the shipped ones hold 16), the case's head sphere for the
        # NeRF, the writer's bust for the fit
        code = tool["main"](["--frames=8", "--size=96x128", "--device=cpu", "--out=" + tmp,
                             "--set", "prepare_data.run_ngp=false",
                             "--set", "prepare_data.fit_bust=false", "--set", "PMVO.patch_size=3",
                             "--set", "infer_inner.render_size=[48,40]",
                             "--set", "mvs.eval_vsize=0.08", "--set", "mvs.eval_batch=4096",
                             "--set", "mvs.occ_model_path=absent",
                             "--set", "mvs.ori_model_path=absent"])
        assert code == 0, code
        assert os.path.exists(os.path.join(tmp, "run_pipeline.log"))
    loaded = sorted(m for m in sys.modules if blocked(m))
    assert not loaded, loaded
    print("TOOL_OK")
''')


def test_run_capture_case_needs_no_jax_cv2_yaml_pil():
    """tools/run_capture_case.py imports nothing the GPU machine lacks, and
    runs the whole pipeline on a small capture case on the CPU: its last line
    is the JSON of what each stage did, with strands grown and the surface
    points on the true hair cap."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", TOOL_GUARDED], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "TOOL_OK"
    result = json.loads(lines[-2])
    assert list(result["stages"]) == ["prepare_data", "pmvo", "infer_inner", "hair_grow"]
    kept = list(result["survivors"].values())
    assert kept[0] > kept[1] >= kept[2] >= kept[3] > 0, kept
    assert result["strands"] > 0 and result["finite"] and result["surface_on_cap"] >= 0.9
    assert result["steps"]["connect_all_segments"]["segments"] > 0


def test_stage_clis_run_on_the_card_unless_told_otherwise(monkeypatch):
    """The stage CLIs pass device "cuda" unless --device is given; only the
    arguments are parsed, so no card is needed."""
    from monohair_tpu_torch import PMVO, HairGrow, infer_inner, prepare_data
    for cli, stage in ((HairGrow, "run_hair_grow"), (PMVO, "run_pmvo"),
                       (infer_inner, "run_infer_inner"), (prepare_data, "run_prepare_data")):
        seen = []
        monkeypatch.setattr(cli, "resolve_config", lambda argv, **kw: argv)
        monkeypatch.setattr(cli, stage, lambda cfg, device: seen.append((cfg, device)))
        cli.main(["--yaml=configs/reconstruct/synthwig", "--HairGenerate.connect_scalp!"])
        cli.main(["--device=cpu", "--yaml=configs/reconstruct/synthwig"])
        assert seen == [(["--yaml=configs/reconstruct/synthwig",
                          "--HairGenerate.connect_scalp!"], "cuda"),
                        (["--yaml=configs/reconstruct/synthwig"], "cpu")]


def test_the_nerf_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """prepare_data hands its device to run_ngp_stage, whose own default, like
    train_ngp's, is the card; only the arguments are looked at."""
    import inspect
    from monohair_tpu_torch import prepare_data
    from monohair_tpu_torch.config import Config
    from monohair_tpu_torch.nerf import pipeline
    for fn in (pipeline.run_ngp_stage, pipeline.train_ngp, pipeline.make_field):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    flags = dict.fromkeys(("select_images", "process_camera", "fit_bust", "process_bust",
                           "render_depth", "process_imgs"), False)
    cfg = Config({"data": {"root": "unused"}, "prepare_data": dict(flags, run_ngp=True)})
    seen = []
    monkeypatch.setattr(prepare_data, "resolve_config", lambda argv, **kw: cfg)
    monkeypatch.setattr(pipeline, "run_ngp_stage", lambda args, device: seen.append(device))
    prepare_data.main(["--yaml=unused"])
    prepare_data.main(["--yaml=unused", "--device=cpu"])
    assert seen == ["cuda", "cpu"]


def test_the_bust_fit_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """prepare_data hands its device to run_bust_fit, whose own default, like
    that of everything it builds on the device, is the card; only the
    arguments are looked at."""
    import inspect
    from monohair_tpu_torch import prepare_data
    from monohair_tpu_torch.bustfit import pipeline, smplx, texture
    from monohair_tpu_torch.config import Config
    from monohair_tpu_torch.pipeline import prepare_data_stage
    from monohair_tpu_torch.segment import annotations, runners
    for fn in (pipeline.run_bust_fit, pipeline.load_fit_problem, smplx.load_smplx_npz,
               texture.load_flame_tex, annotations.default_backends, runners.LandmarkRunner):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    flags = dict.fromkeys(("select_images", "process_camera", "run_ngp", "process_bust",
                           "render_depth", "process_imgs"), False)
    cfg = Config({"data": {"root": "unused"}, "prepare_data": dict(flags, fit_bust=True)})
    seen = []
    monkeypatch.setattr(prepare_data, "resolve_config", lambda argv, **kw: cfg)
    monkeypatch.setattr(pipeline, "run_bust_fit", lambda args, device: seen.append(device))
    monkeypatch.setattr(prepare_data_stage, "promote_fit_artifacts", lambda args: None)
    prepare_data.main(["--yaml=unused"])
    prepare_data.main(["--yaml=unused", "--device=cpu"])
    assert seen == ["cuda", "cpu"]
