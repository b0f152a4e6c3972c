"""The port's OpenCV drawing rules (monohair_tpu_torch/segment/draw.py) and the
segmentation nets' training frames (segment/frames.py) against the installed
cv2 and tools/train_hair_parser.py, on the CPU. Every comparison is bitwise:
each primitive on seeded and hypothesis cases (frame edges, ends outside the
image, thickness 1-5), then the tool's frame functions, whose module-level
frame size S is patched here, on 20 seeds at S=96 and 2 at 512, with the
Generator's state after each frame equal too."""

import os
import sys

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from monohair_tpu_torch.segment import draw, frames

HERE = os.path.dirname(os.path.abspath(__file__))
TOOLS = os.path.join(os.path.dirname(HERE), "tools")
SETTINGS = settings(max_examples=150, deadline=None, derandomize=True, database=None)
S = 64


@pytest.fixture(scope="module")
def tool():
    """tools/train_hair_parser.py as a module (its directory on the path for
    its own import of make_capture_case)."""
    sys.path.insert(0, TOOLS)
    try:
        import train_hair_parser
        yield train_hair_parser
    finally:
        sys.path.remove(TOOLS)


def canvas(channels: int, value: int = 0) -> np.ndarray:
    shape = (S, S + 7) if channels == 1 else (S, S + 7, channels)
    return np.full(shape, value, np.uint8)


coord = st.integers(-40, S + 40)
point = st.tuples(coord, coord)


@SETTINGS
@given(center=point, axes=st.tuples(st.integers(0, 90), st.integers(0, 90)),
       angle=st.floats(-400, 400, allow_nan=False), channels=st.sampled_from([1, 3]))
def test_filled_ellipse_is_cv2s(center, axes, angle, channels):
    color = (255, 7, 128)[:channels]
    want = cv2.ellipse(canvas(channels), center, axes, angle, 0, 360, color, -1)
    got = draw.ellipse(canvas(channels), center, axes, angle, color)
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(p0=point, p1=point, thickness=st.integers(1, 5), channels=st.sampled_from([1, 3]))
def test_line_is_cv2s(p0, p1, thickness, channels):
    color = (200, 30, 90)[:channels]
    want = cv2.line(canvas(channels), p0, p1, color, thickness)
    got = draw.line(canvas(channels), p0, p1, color, thickness)
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(pts=st.lists(point, min_size=2, max_size=9), thickness=st.integers(1, 5))
def test_open_polylines_are_cv2s(pts, thickness):
    pts = np.array(pts, np.int32)
    want = cv2.polylines(canvas(1), [pts], False, 1, thickness=thickness)
    got = draw.polylines(canvas(1), pts, 1, thickness)
    np.testing.assert_array_equal(got, want)


def test_primitives_on_seeded_frames():
    """The frames' own calls: 300 ellipses, lines and strand polylines drawn
    one over another on a 3-channel and a mask canvas of 512x512."""
    rng = np.random.default_rng(0)
    want, got = np.zeros((512, 512, 3), np.uint8), np.zeros((512, 512, 3), np.uint8)
    mwant, mgot = np.zeros((512, 512), np.uint8), np.zeros((512, 512), np.uint8)
    for _ in range(100):
        c = tuple(int(v) for v in rng.integers(0, 512, 2))
        ax = tuple(int(v) for v in rng.integers(15, 120, 2))
        ang = float(rng.uniform(0, 180))
        col = tuple(int(v) for v in rng.integers(0, 256, 3))
        cv2.ellipse(want, c, ax, ang, 0, 360, col, -1)
        draw.ellipse(got, c, ax, ang, col)
        p0, p1 = tuple(rng.integers(0, 512, 2)), tuple(rng.integers(0, 512, 2))
        t = int(rng.integers(1, 6))
        cv2.line(want, p0, p1, col, t)
        draw.line(got, p0, p1, col, t)
        pts = (rng.uniform(-100, 612, (8, 2))).astype(np.int32)
        t = int(rng.integers(1, 5))
        cv2.polylines(mwant, [pts], False, 1, thickness=t)
        draw.polylines(mgot, pts, 1, t)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mgot, mwant)


@pytest.mark.parametrize("ksize", [3, 5])
@pytest.mark.parametrize("shape", [(64, 71, 3), (5, 3, 3), (37, 2, 1), (512, 512, 3)])
def test_gaussian_blur_is_cv2s(ksize, shape):
    rng = np.random.default_rng(ksize)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    if shape[2] == 1:
        img = img[..., 0]
    np.testing.assert_array_equal(draw.gaussian_blur(img, ksize),
                                  cv2.GaussianBlur(img, (ksize, ksize), 0))


@SETTINGS
@given(src=st.tuples(st.integers(1, 300), st.integers(1, 300)),
       dst=st.tuples(st.integers(1, 200), st.integers(1, 200)))
def test_nearest_resize_is_cv2s(src, dst):
    img = np.random.default_rng(src[0]).integers(0, 20, src).astype(np.uint8)
    np.testing.assert_array_equal(draw.resize_nearest(img, dst),
                                  cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("ksize", [13, 3])
def test_dilate_and_erode_are_cv2s(ksize):
    """On {0, 1} float32 mattes touching the border."""
    rng = np.random.default_rng(ksize)
    m = (rng.random((3, 40, 57)) < 0.3).astype(np.float32)
    m[0, :5] = 1.0
    kern = np.ones((ksize, ksize), np.uint8)
    t = torch.from_numpy(m)
    for got, fn in ((draw.dilate(t, ksize), cv2.dilate), (draw.erode(t, ksize), cv2.erode)):
        np.testing.assert_array_equal(got.numpy(), np.stack([fn(x, kern) for x in m]))


def tool_band(y: np.ndarray) -> np.ndarray:
    """train_hair_parser.py's boundary_band (nested in its main)."""
    kern = np.ones((13, 13), np.uint8)
    return np.stack([cv2.dilate(m, kern) - cv2.erode(m, kern) for m in y])


@pytest.mark.parametrize("size,seeds", [(96, range(20)), (512, range(2))])
def test_frames_are_the_tools(tool, monkeypatch, size, seeds):
    """render_frame, render_case_frame (and through them finish_frame) give
    the tool's frame and label bit for bit from the same seed and leave the
    Generator in the same state; matte_from_label and boundary_band give the
    tool's targets."""
    monkeypatch.setattr(tool, "S", size)
    for seed in seeds:
        for name in ("render_frame", "render_case_frame"):
            r_tool, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
            img, label = getattr(tool, name)(r_tool)
            got_img, got_label = getattr(frames, name)(r_port, size)
            np.testing.assert_array_equal(got_img, img, err_msg=f"{name} {seed}")
            np.testing.assert_array_equal(got_label, label, err_msg=f"{name} {seed}")
            assert r_port.bit_generator.state == r_tool.bit_generator.state, (name, seed)
            y = tool.matte_from_label(label[None])
            matte = frames.matte_from_label(torch.from_numpy(label[None]))
            np.testing.assert_array_equal(matte.numpy(), y)
            np.testing.assert_array_equal(frames.boundary_band(matte).numpy(), tool_band(y))


def test_finish_frame_is_the_tools(tool):
    """finish_frame alone, over enough seeds to take both blurs and no blur."""
    blurred = set()
    for seed in range(24):
        img = np.random.default_rng(100 + seed).random((40, 52, 3))
        r_tool, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
        want = tool.finish_frame(img, None, r_tool)[0]
        got = frames.finish_frame(img, None, r_port)[0]
        np.testing.assert_array_equal(got, want)
        blurred.add(int(np.random.default_rng(seed).random(4)[3] < 0.3))
    assert blurred == {0, 1}


def test_render_frames_draws_the_tools_set(tool, monkeypatch):
    """render_frames consumes the Generator as the tool's list comprehension
    does (a coin, then the frame), at S=96."""
    monkeypatch.setattr(tool, "S", 96)
    r_tool, r_port = np.random.default_rng(5), np.random.default_rng(5)
    want = [tool.render_case_frame(r_tool) if r_tool.random() < 0.25 else tool.render_frame(r_tool)
            for _ in range(6)]
    got_f, got_l = frames.render_frames(r_port, 6, 96)
    np.testing.assert_array_equal(got_f, np.stack([f for f, _ in want]))
    np.testing.assert_array_equal(got_l, np.stack([lab for _, lab in want]))
