"""Fixture trees of the evaluation datasets, written by the tests (cv2, PIL
and the port's own PNG / PCD writers), and the helpers of the
tests/test_torch_eval_*.py files.

Each writer makes a small tree in the dataset's layout, with seeded random
images, label images with a table (id 1), and clouds with NaN holes. The
paths must not contain "rgb" or "table" outside the layout (the readers
replace and test those words in the full path), so tests name their
temporary directories plainly.
"""

import json
import os
import struct
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_native import _lzf_compress  # noqa: E402  the LZF coder with back references


def random_scene(rng, h, w, n_objects=4, floor=False):
    """(bgr uint8 [h, w, 3], label [h, w] uint8 with table 1 in the lower
    half, objects 2.. (3.. when floor: then floor id 2 in the top rows),
    xyz float32 [h, w, 3] with NaN holes)."""
    bgr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    label = np.zeros((h, w), np.uint8)
    label[h // 2:] = 1
    first = 2
    if floor:
        label[: h // 6] = 2
        first = 3
    for k in range(n_objects):
        y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
        label[y:y + rng.randint(4, h // 3), x:x + rng.randint(4, w // 3)] = first + k
    xyz = np.stack([rng.randn(h, w), rng.randn(h, w), rng.rand(h, w) + 0.5], -1)
    xyz = xyz.astype(np.float32)
    xyz[rng.rand(h, w) < 0.05] = np.nan
    return bgr, label, xyz


def write_pcd_compressed(path, xyz):
    """A binary_compressed PCD whose LZF stream has back references (the
    port's writer emits literal runs only): fields x y z, field-major."""
    h, w, _ = xyz.shape
    pts = xyz.reshape(-1, 3)
    body = b"".join(np.ascontiguousarray(pts[:, i]).astype("<f4").tobytes() for i in range(3))
    comp = _lzf_compress(body)
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
              "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
              f"WIDTH {w}\nHEIGHT {h}\nVIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {h * w}\nDATA binary_compressed\n").encode()
    Path(path).write_bytes(header + struct.pack("<II", len(comp), len(body)) + comp)


def write_paletted(path, label):
    from PIL import Image

    im = Image.fromarray(label.astype(np.uint8), mode="P")
    im.putpalette((np.arange(256 * 3) * 7 % 256).astype(np.uint8).tolist())
    im.save(path)


def write_ocid_tree(root, rng, h=48, w=64, frames=2, depth_png=False):
    """OCID layout: <seq>/{rgb,label,pcd}/<frame>.png|.pcd in a 'table'
    sequence (floor id 2 suppressed: paletted labels written by PIL, clouds
    LZF with back references) and a floor sequence (16-bit labels written
    by cv2, clouds by the port's writer as binary_compressed). depth_png
    also writes depth/<frame>.png (mm, uint16) for the UOAIS reader."""
    import cv2

    from unseenobjectswithmeanshift_torch.data.pcd import write_pcd_xyz

    seqs = [(Path(root) / "ARID20" / "table" / "top" / "seq01", True),
            (Path(root) / "ARID10" / "floor" / "bottom" / "seq02", False)]
    for seq, on_table in seqs:
        for sub in ("rgb", "label", "pcd") + (("depth",) if depth_png else ()):
            (seq / sub).mkdir(parents=True, exist_ok=True)
        for f in range(frames):
            bgr, label, xyz = random_scene(rng, h, w, floor=on_table)
            name = f"result_{f:04d}"
            cv2.imwrite(str(seq / "rgb" / f"{name}.png"), bgr)
            if on_table:
                write_paletted(str(seq / "label" / f"{name}.png"), label)
                write_pcd_compressed(seq / "pcd" / f"{name}.pcd", xyz)
            else:
                cv2.imwrite(str(seq / "label" / f"{name}.png"), label.astype(np.uint16))
                write_pcd_xyz(str(seq / "pcd" / f"{name}.pcd"), xyz)
            if depth_png:
                depth = np.nan_to_num(xyz[..., 2] * 1000).astype(np.uint16)
                cv2.imwrite(str(seq / "depth" / f"{name}.png"), depth)
    return str(root)


def write_osd_tree(root, rng, h=48, w=64, frames=2, disparity=False):
    """OSD layout: image_color/, annotation/ (paletted), pcd/ (ascii and
    binary clouds); disparity also writes disparity/ depth PNGs for the
    UOAIS reader."""
    import cv2

    from unseenobjectswithmeanshift_torch.data.pcd import write_pcd_xyz

    root = Path(root)
    for sub in ("image_color", "annotation", "pcd") + (("disparity",) if disparity else ()):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for f in range(frames):
        bgr, label, xyz = random_scene(rng, h, w)
        label[label == 1] = 0                      # OSD has no table id
        name = f"learn{f}"
        cv2.imwrite(str(root / "image_color" / f"{name}.png"), bgr)
        write_paletted(str(root / "annotation" / f"{name}.png"), label)
        write_pcd_xyz(str(root / "pcd" / f"{name}.pcd"), xyz, kind=("ascii", "binary")[f % 2])
        if disparity:
            depth = np.nan_to_num(xyz[..., 2] * 1000).astype(np.uint16)
            cv2.imwrite(str(root / "disparity" / f"{name}.png"), depth)
    return str(root)


def write_tod_tree(root, rng, h=48, w=64, scenes=1):
    """TOD test_set layout: scene_*/rgb_*.jpeg, depth_*.png (uint16 mm),
    segmentation_*.png (8-bit grey, table 1), 7 views a scene."""
    import cv2

    for s in range(scenes):
        d = Path(root) / "test_set" / f"scene_{s:05d}"
        d.mkdir(parents=True)
        for v in range(7):
            bgr, label, xyz = random_scene(rng, h, w)
            cv2.imwrite(str(d / f"rgb_{v:05d}.jpeg"), bgr)
            cv2.imwrite(str(d / f"depth_{v:05d}.png"),
                        np.nan_to_num(xyz[..., 2] * 1000).astype(np.uint16))
            cv2.imwrite(str(d / f"segmentation_{v:05d}.png"), label)
    return str(root)


def write_pushing_tree(root, rng, h=48, w=64, frames=3):
    """Pushing layout: seq/<i>-color.png, -depth.png, -label.png (one frame
    without a label file) and camera_params.json."""
    import cv2

    d = Path(root) / "seq00"
    d.mkdir(parents=True)
    for f in range(frames):
        bgr, label, xyz = random_scene(rng, h, w)
        cv2.imwrite(str(d / f"{f:06d}-color.png"), bgr)
        cv2.imwrite(str(d / f"{f:06d}-depth.png"),
                    np.nan_to_num(xyz[..., 2] * 1000).astype(np.uint16))
        if f:
            write_paletted(str(d / f"{f:06d}-label.png"), label)
    with open(Path(root) / "camera_params.json", "w") as fh:
        json.dump({"fx": 50.0, "fy": 51.0, "x_offset": w / 2, "y_offset": h / 2}, fh)
    return str(root)


def write_uoais_sim_tree(root, rng, h=48, w=64):
    """UOAIS-Sim: a COCO json with an RLE and a polygon annotation, images
    and depth PNGs."""
    import cv2

    from unseenobjectswithmeanshift_torch.data.uoais import rle_encode

    root = Path(root)
    (root / "color").mkdir(parents=True)
    (root / "depth").mkdir()
    images, anns = [], []
    for i in range(2):
        bgr, label, xyz = random_scene(rng, h, w)
        cv2.imwrite(str(root / "color" / f"{i}.png"), bgr)
        depth = (rng.rand(h, w) * 12000 + 2000).astype(np.uint16)
        depth[:3, :3] = 0
        cv2.imwrite(str(root / "depth" / f"{i}.png"), depth)
        images.append({"id": i, "height": h, "width": w, "file_name": f"color/{i}.png",
                       "depth_file_name": f"depth/{i}.png"})
        anns.append({"image_id": i, "segmentation": rle_encode(label == 2)})
        anns.append({"image_id": i, "segmentation": [[2, 2, 20, 3, 18, 20, 3, 15]]})
    with open(root / "coco.json", "w") as fh:
        json.dump({"images": images, "annotations": anns}, fh)
    return str(root)


def assert_samples_equal(got, want):
    """Two reader samples equal bit for bit, dtype included."""
    assert got.keys() == want.keys()
    assert got["file_name"] == want["file_name"]
    for k in ("image", "xyz", "label"):
        if want[k] is None:
            assert got[k] is None, k
            continue
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def shrink(cfg):
    """tests/test_cli_eval.py's _shrink: the eval CLI at toy width."""
    cfg.decoder.num_queries = 8
    cfg.decoder.hidden_dim = 32
    cfg.decoder.dim_feedforward = 64
    cfg.decoder.dec_layers = 2
    cfg.decoder.nheads = 4
    cfg.decoder.mask_dim = 32
    cfg.decoder.conv_dim = 16
    cfg.backbone.num_units = 16
    cfg.pixel_decoder.conv_dim = 16
    cfg.pixel_decoder.mask_dim = 32
    cfg.test.max_instances = 4
    cfg.test.crop_size = 32
    return cfg


def env():
    e = dict(os.environ)
    e["PYTHONPATH"] = str(REPO) + os.pathsep + e.get("PYTHONPATH", "")
    return e
