"""The port's foundations against the JAX package on the same numpy inputs:
camera math, voxel coordinates, config, PNG/OBJ/JSON/.mat I/O and the raw
point preparation."""

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monohair_tpu.camera as jcam
import monohair_tpu.coords as jcoords
import monohair_tpu_torch.camera as tcam
import monohair_tpu_torch.coords as tcoords
from tests.test_camera import make_cameras

torch.set_num_threads(1)


def both_cameras(rng, num_views=4):
    cams = make_cameras(rng, num_views)
    return cams, tcam.Cameras.from_numpy(np.asarray(cams.ndc), np.asarray(cams.w2c), "cpu")


def test_cameras_from_json_list_and_getitem(rng):
    import json
    cam_list = []
    for v in range(3):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.1 * v, 0.2, 1.0 + v]
        cam_list.append({"file": f"{v:03d}", "ndc_prj": [1.5, 1.2, 0.01 * v, 0.0],
                         "pose": c2w.tolist()})
    cam_list = json.loads(json.dumps(cam_list))
    j = jcam.Cameras.from_json_list(cam_list)
    t = tcam.Cameras.from_json_list(cam_list, device="cpu")
    np.testing.assert_array_equal(t.w2c.numpy(), np.asarray(j.w2c))
    np.testing.assert_array_equal(t.ndc.numpy(), np.asarray(j.ndc))
    assert t.num_views == 3 and t[1].num_views == 1
    np.testing.assert_array_equal(t[np.array([2, 0])].w2c.numpy(),
                                  np.asarray(j[np.array([2, 0])].w2c))


def test_project_unproject_match_jax(rng):
    jc, tc = both_cameras(rng)
    pts = (rng.random((200, 3)).astype(np.float32) - 0.5) * 0.4
    uv_j, z_j = jcam.project(jc, jnp.asarray(pts))
    uv_t, z_t = tcam.project(tc, torch.from_numpy(pts))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-5, atol=1e-6)
    back_j = jcam.unproject(jc, uv_j, z_j)
    back_t = tcam.unproject(tc, uv_t, z_t)
    np.testing.assert_allclose(back_t.numpy(), np.asarray(back_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back_t.numpy(), np.broadcast_to(pts, back_t.shape),
                               atol=1e-5)
    rc_t = tcam.ndc_to_pixel(uv_t, (48, 64))
    np.testing.assert_allclose(rc_t.numpy(), np.asarray(jcam.ndc_to_pixel(uv_j, (48, 64))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tcam.pixel_to_ndc(rc_t, (48, 64)).numpy(), uv_t.numpy(),
                               atol=1e-5)


def test_pixel_index_and_validity_rounds_half_to_even_then_checks_then_clamps():
    H, W = 8, 8
    # col = (-u + 1) * 0.5 * W and row = (v + 1) * 0.5 * H, exact in f32
    cols = np.array([2.5, 3.5, -0.5, 7.5, 8.5, 0.5, 4.0, -0.6, 7.4], np.float32)
    rows = np.array([3.5, 2.5, 0.5, -0.5, 7.5, 8.5, 4.0, 7.4, -0.6], np.float32)
    u = 1.0 - cols * 2.0 / W
    v = rows * 2.0 / H - 1.0
    uv = np.stack([u, v], -1)[None]
    rc_j, inv_j = jcam.pixel_index_and_validity(jnp.asarray(uv), (H, W))
    rc_t, inv_t = tcam.pixel_index_and_validity(torch.from_numpy(uv), (H, W))
    np.testing.assert_array_equal(rc_t.numpy(), np.asarray(rc_j))
    np.testing.assert_array_equal(inv_t.numpy(), np.asarray(inv_j))
    assert rc_t.dtype == torch.int32
    # 2.5 -> 2, 3.5 -> 4, -0.5 -> -0 (valid), 7.5 -> 8 (invalid, clamped to 7)
    assert rc_t[0, 0].tolist() == [4, 2] and rc_t[0, 1].tolist() == [2, 4]
    assert inv_t[0].tolist() == [False, False, False, True, True, True, False,
                                 True, True]
    assert rc_t[0, 4].tolist() == [7, 7]


def test_pixel_indices_of_random_points_match_jax(rng):
    jc, tc = both_cameras(rng, 6)
    pts = (rng.random((2000, 3)).astype(np.float32) - 0.5) * 0.6
    uv_j, _ = jcam.project(jc, jnp.asarray(pts))
    uv_t, _ = tcam.project(tc, torch.from_numpy(pts))
    rc_j, inv_j = jcam.pixel_index_and_validity(uv_j, (1920, 1080))
    rc_t, inv_t = tcam.pixel_index_and_validity(uv_t, (1920, 1080))
    # f32 products may round differently; an index may move by one pixel only
    # where a projection lies within an ulp of a pixel boundary
    diff = np.abs(rc_t.numpy() - np.asarray(rc_j))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert (inv_t.numpy() != np.asarray(inv_j)).mean() < 1e-3


def test_voxel_coordinates_match_jax(rng):
    pts = (rng.random((500, 3)).astype(np.float32) - 0.5) * 0.8
    # exact half-voxel points: (x - vmin) / vsize = k + 0.5
    half = (np.array([[10.5, 20.5, 30.5], [11.5, 21.5, 31.5]], np.float32)
            * np.float32(jcoords.VOXEL_SIZE) + jcoords.VOXEL_MIN) * np.array([1, -1, -1],
                                                                             np.float32)
    pts = np.concatenate([pts, half])
    tp = torch.from_numpy(pts)
    np.testing.assert_allclose(tcoords.world_to_voxel(tp).numpy(),
                               np.asarray(jcoords.world_to_voxel(jnp.asarray(pts))),
                               rtol=1e-6, atol=1e-4)
    idx_t = tcoords.voxel_indices(tp)
    np.testing.assert_array_equal(idx_t.numpy(),
                                  np.asarray(jcoords.voxel_indices(jnp.asarray(pts))))
    np.testing.assert_array_equal(
        tcoords.flat_voxel_id(idx_t).numpy(),
        np.asarray(jcoords.flat_voxel_id(jcoords.voxel_indices(jnp.asarray(pts)))))


# ---------------------------------------------------------------------------
# I/O
# ---------------------------------------------------------------------------

def png_images(rng):
    gradient = (np.add.outer(np.arange(40), np.arange(56)) % 256).astype(np.uint8)
    smooth = (np.sin(np.linspace(0, 9, 33 * 47)).reshape(33, 47) * 120 + 128).astype(np.uint8)
    return {
        "gray_noise": rng.integers(0, 256, (37, 53), dtype=np.uint8),
        "gray_gradient": gradient,
        "gray_smooth": smooth,
        "bgr_noise": rng.integers(0, 256, (29, 31, 3), dtype=np.uint8),
        "bgr_smooth": np.stack([smooth, smooth[::-1], smooth[:, ::-1]], -1),
        "bgr_gray_pixels": np.repeat(gradient[..., None], 3, -1),
        "black": np.zeros((16, 16), np.uint8),
    }


def test_png_reader_matches_cv2(tmp_path, rng):
    import cv2
    from monohair_tpu_torch.io.image_io import imread_bgr, imread_gray, read_png
    for name, img in png_images(rng).items():
        path = str(tmp_path / f"{name}.png")
        assert cv2.imwrite(path, img)
        np.testing.assert_array_equal(imread_gray(path),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE), err_msg=name)
        np.testing.assert_array_equal(imread_bgr(path), cv2.imread(path), err_msg=name)
        raw = read_png(path)
        np.testing.assert_array_equal(raw if raw.ndim == 2 else raw[..., ::-1], img,
                                      err_msg=name)


def test_png_writer_read_by_cv2_and_back(tmp_path, rng):
    import cv2
    from monohair_tpu_torch.io.image_io import read_png, write_png
    for name, img in png_images(rng).items():
        path = str(tmp_path / f"{name}.png")
        rgb = img if img.ndim == 2 else img[..., ::-1]
        write_png(path, rgb)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(read_png(path), rgb)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "bad.png"), np.zeros((4, 4), np.float32))


def test_map_loaders_match_jax(tmp_path, rng):
    import cv2
    from monohair_tpu.io import image_io as jio
    from monohair_tpu_torch.io import image_io as tio
    views = ["000", "001"]
    for sub in ("ori", "conf", "mask", "depth"):
        (tmp_path / sub).mkdir()
    for v in views:
        cv2.imwrite(str(tmp_path / "ori" / f"{v}.png"),
                    rng.integers(0, 180, (12, 14), dtype=np.uint8))
        cv2.imwrite(str(tmp_path / "conf" / f"{v}.png"),
                    rng.integers(0, 256, (12, 14), dtype=np.uint8))
        cv2.imwrite(str(tmp_path / "mask" / f"{v}.png"),
                    rng.integers(0, 256, (12, 14, 3), dtype=np.uint8))
        np.save(tmp_path / "depth" / f"{v}.npy",
                rng.random((12, 14, 3)).astype(np.float32) * 255)
    for a, b in zip(tio.load_orientation_and_confidence(views, str(tmp_path / "ori"),
                                                        str(tmp_path / "conf")),
                    jio.load_orientation_and_confidence(views, str(tmp_path / "ori"),
                                                        str(tmp_path / "conf"))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tio.load_masks(views, str(tmp_path / "mask")),
                                  jio.load_masks(views, str(tmp_path / "mask")))
    np.testing.assert_array_equal(tio.load_depth_maps(views, str(tmp_path / "depth")),
                                  jio.load_depth_maps(views, str(tmp_path / "depth")))


def test_mat_files_cross_read(tmp_path, rng):
    from monohair_tpu.io import mat_io as jmat
    from monohair_tpu_torch.io import mat_io as tmat
    occ = (rng.random((6, 5, 4)) > 0.5).astype(np.float32)
    ori = rng.normal(size=(6, 5, 4, 3)).astype(np.float32)
    tmat.save_occ_ori_mat(str(tmp_path / "port"), occ, ori)
    np.testing.assert_array_equal(jmat.load_occ_mat(str(tmp_path / "port/Occ3D.mat")), occ)
    np.testing.assert_array_equal(jmat.load_ori_mat(str(tmp_path / "port/Ori3D.mat")), ori)
    jmat.save_occ_ori_mat(str(tmp_path / "jax"), occ, ori)
    for name in ("Occ3D.mat", "Ori3D.mat"):
        assert ((tmp_path / "port" / name).read_bytes()[128:]
                == (tmp_path / "jax" / name).read_bytes()[128:])  # past the dated header
    np.testing.assert_array_equal(tmat.load_ori_mat(str(tmp_path / "jax/Ori3D.mat")), ori)
    np.testing.assert_array_equal(tmat.load_occ_mat(str(tmp_path / "jax/Occ3D.mat")), occ)


def test_obj_cameras_and_points_match_jax(tmp_path, rng):
    from monohair_tpu.io import cameras_io as jcio, mesh_io as jmesh
    from monohair_tpu.pmvo import points as jpoints
    from monohair_tpu_torch.io import cameras_io as tcio, mesh_io as tmesh
    from monohair_tpu_torch.pmvo import points as tpoints
    verts = rng.normal(size=(30, 3)) * 0.05
    faces = rng.integers(0, 30, (40, 3))
    tmesh.save_obj(str(tmp_path / "m.obj"), verts, faces)
    v, f = jmesh.load_obj(str(tmp_path / "m.obj"))
    v2, f2 = tmesh.load_obj(str(tmp_path / "m.obj"))
    np.testing.assert_array_equal(v, v2)
    np.testing.assert_array_equal(f, f2)
    a = tmesh.sample_mesh_surface(v, f, 500, np.random.default_rng(3))
    b = jmesh.sample_mesh_surface(v, f, 500, np.random.default_rng(3))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        tpoints.load_colmap_points(str(tmp_path / "m.obj"), num_per_grid=2),
        jpoints.load_colmap_points(str(tmp_path / "m.obj"), num_per_grid=2))

    jc, _ = both_cameras(rng, 5)
    names = [f"{i:03d}" for i in range(5)]
    c2w = np.linalg.inv(np.asarray(jc.w2c))
    tcio.save_cam_params(str(tmp_path / "cam.json"), names, np.asarray(jc.ndc), c2w)
    (tmp_path / "imgs").mkdir()
    for n in names[::2]:
        (tmp_path / "imgs" / f"{n}.png").write_bytes(b"")
    jn, jcams = jcio.subsample_views(*jcio.load_cam_params(str(tmp_path / "cam.json")),
                                     str(tmp_path / "imgs"))
    tn, tcams = tcio.subsample_views(*tcio.load_cam_params(str(tmp_path / "cam.json"),
                                                           "cpu"), str(tmp_path / "imgs"))
    assert tn == jn == names[::2]
    np.testing.assert_array_equal(tcams.w2c.numpy(), np.asarray(jcams.w2c))



OBJ_TEXTS = {
    # plain triangles in every float spelling, among records the loader skips
    "plain": "# mesh\no head\nv 0.5 -1e-3 2.5E+2\nv +3 -0.0 1.234567890123456789\n"
             "vn 0 0 1\n\nv 7 8 9.000000001\nf 1 2 3\nf 3 2 1\n",
    # a quad, fan-triangulated by the general parser
    "quad": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n",
    # corners with texture indices
    "uv": "v 0 0 0\nv 1 0 0\nv 1 1 0\nvt 0 0\nvt 1 0\nvt 1 1\nf 1/1 2/2 3/3\n",
}


@pytest.mark.parametrize("kind", sorted(OBJ_TEXTS))
def test_obj_loader_reads_as_the_jax_loader(tmp_path, kind):
    from monohair_tpu.io import mesh_io as jmesh
    from monohair_tpu_torch.io import mesh_io as tmesh
    path = tmp_path / "m.obj"
    path.write_text(OBJ_TEXTS[kind])
    v, f = jmesh.load_obj(str(path))
    v2, f2 = tmesh.load_obj(str(path))
    np.testing.assert_array_equal(v, v2)
    np.testing.assert_array_equal(f, f2)
    assert v2.dtype == np.float64 and f2.dtype == np.int64 and f2.shape[1] == 3


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_config_matches_jax(tmp_path):
    from monohair_tpu import config as jconf
    from monohair_tpu_torch import config as tconf
    argv = ["--yaml=configs/reconstruct/synthwig", "--PMVO.patch_size=5",
            "--PMVO.optimize", "--PMVO.infer_inner!", "--data.case="]
    j = jconf.parse_arguments(argv)
    t = tconf.parse_arguments(argv)
    assert t.to_dict() == j.to_dict()
    jo = jconf.set_options(j, allow_new=False).to_dict()
    to = tconf.set_options(t, allow_new=False).to_dict()
    assert to.pop("device") == "cuda" and jo.pop("device") == "jax"
    assert to == jo
    with pytest.raises(KeyError, match="unknown config key"):
        tconf.set_options(tconf.parse_arguments(["--yaml=configs/reconstruct/synthwig",
                                                 "--PMVO.bogus=1"]), allow_new=False)
    path = tconf.save_options_file(tconf.Config(to), str(tmp_path))
    assert open(path).read() == open(jconf.save_options_file(
        jconf.Config(to), str(tmp_path / "j"))).read()


def test_synthwig_config_in_code_matches_the_yaml():
    from monohair_tpu_torch import config as tconf
    from monohair_tpu_torch.synthetic import synthwig_config
    resolved = tconf.set_options(tconf.parse_arguments(
        ["--yaml=configs/reconstruct/synthwig"]), allow_new=False)
    ours = synthwig_config("/tmp/verify_data")
    for key, value in ours.items():
        if key in ("yaml",):
            continue
        assert resolved[key] == value, key


def test_patch_and_pixel_gathers_match_jax(rng):
    from monohair_tpu.ops import grid_sample as jgs
    from monohair_tpu_torch.ops import grid_sample as tgs
    image = rng.normal(size=(9, 11, 3)).astype(np.float32)
    rc = np.stack([rng.integers(-2, 11, 30), rng.integers(-2, 13, 30)], -1).astype(np.int32)
    for img in (image, image[..., 0]):
        np.testing.assert_array_equal(
            tgs.gather_patches(torch.from_numpy(img), torch.from_numpy(rc), 5).numpy(),
            np.asarray(jgs.gather_patches(jnp.asarray(img), jnp.asarray(rc), 5)))
    inside = np.clip(rc, 0, [8, 10]).astype(np.int32)
    np.testing.assert_array_equal(
        tgs.gather_pixels(torch.from_numpy(image), torch.from_numpy(inside)).numpy(),
        np.asarray(jgs.gather_pixels(jnp.asarray(image), jnp.asarray(inside))))
