"""PCD (Point Cloud Data) files: the xyz of OCID / OSD organized clouds.

Port of ``unseenobjectswithmeanshift_tpu.data.pcd`` (ref:
lib/datasets/ocid_object.py:106-114, osd_object.py:100-108, which read the
xyz fields with open3d and reshape to [H, W, 3]): ``read_pcd_xyz`` for
``ascii``, ``binary`` and ``binary_compressed`` (LZF, field-major) PCD v0.7,
NaN -> 0. The LZF stream is decoded by the native library
(``backend="native"``; OCID's clouds are all LZF, and the Python loop takes
milliseconds a cloud) or by ``_lzf_decompress`` (``backend="numpy"``, the
pure-Python twin). ``write_pcd_xyz`` writes the three kinds, its LZF as
literal runs only (valid LZF without back references).
"""

from __future__ import annotations

import struct

import numpy as np

from .. import native

_DTYPES = {("F", 4): np.float32, ("F", 8): np.float64,
           ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
           ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32}


def _lzf_decompress(data: bytes, expected: int) -> bytes:
    """LZF decompression (the PCL binary_compressed codec), pure Python."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run
            cnt = ctrl + 1
            out += data[i:i + cnt]
            i += cnt
        else:          # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    return bytes(out)


def lzf_literal(data: bytes) -> bytes:
    """LZF of data as literal runs of up to 32 bytes (no compression)."""
    src = np.frombuffer(data, np.uint8)
    full = len(src) // 32
    runs = np.empty((full, 33), np.uint8)
    runs[:, 0] = 31
    runs[:, 1:] = src[:full * 32].reshape(full, 32)
    tail = src[full * 32:]
    head = bytes([len(tail) - 1]) + tail.tobytes() if len(tail) else b""
    return runs.tobytes() + head


def read_pcd_xyz(path: str, backend: str = "native") -> np.ndarray:
    """Read a PCD file, return [N, 3] float32 xyz with NaN -> 0
    (mirroring the reference's pcloud[np.isnan(pcloud)] = 0)."""
    native.check_backend(backend)
    with open(path, "rb") as f:
        header = {}
        while True:
            raw_line = f.readline()
            if not raw_line:
                raise ValueError(f"{path}: PCD header without a DATA line")
            line = raw_line.decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        body = f.read()

    fields = header["FIELDS"].split()
    sizes = [int(s) for s in header["SIZE"].split()]
    types = header["TYPE"].split()
    counts = [int(c) for c in header.get("COUNT", " ".join(["1"] * len(fields))).split()]
    npoints = int(header["POINTS"])
    data_kind = header["DATA"].split()[0]

    dtype_fields = []
    for f_, s_, t_, c_ in zip(fields, sizes, types, counts):
        base = _DTYPES[(t_, s_)]
        if c_ == 1:
            dtype_fields.append((f_, base))
        else:
            dtype_fields.append((f_, base, (c_,)))
    rec = np.dtype(dtype_fields)

    if data_kind == "ascii":
        arr = np.loadtxt(body.decode("ascii", "ignore").splitlines(), dtype=np.float64)
        arr = arr.reshape(npoints, -1)
        idx = [fields.index(k) for k in ("x", "y", "z")]
        xyz = arr[:, idx].astype(np.float32)
    elif data_kind == "binary":
        arr = np.frombuffer(body[: rec.itemsize * npoints], dtype=rec)
        xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float32)
    elif data_kind == "binary_compressed":
        comp_size, uncomp_size = struct.unpack("<II", body[:8])
        stream = body[8:8 + comp_size]
        if backend == "native":
            raw = native.lzf_decompress(stream, uncomp_size)
        else:
            raw = _lzf_decompress(stream, uncomp_size)
        # binary_compressed stores data FIELD-MAJOR (all x, then all y, ...)
        xyz_cols = []
        offset = 0
        for f_, s_, t_, c_ in zip(fields, sizes, types, counts):
            width = s_ * c_ * npoints
            if f_ in ("x", "y", "z"):
                col = np.frombuffer(raw[offset:offset + width],
                                    dtype=_DTYPES[(t_, s_)])[:npoints]
                xyz_cols.append((f_, col))
            offset += width
        cols = dict(xyz_cols)
        xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float32)
    else:
        raise ValueError(f"unsupported PCD DATA kind: {data_kind}")

    xyz = np.nan_to_num(xyz, nan=0.0)
    return xyz


def write_pcd_xyz(path: str, xyz, kind: str = "binary_compressed") -> None:
    """An organized cloud [H, W, 3] float32 (NaN kept) as a PCD v0.7 file of
    FIELDS x y z rgb, as OCID's clouds are laid out (the packed rgb field
    written as 0); kind ascii, binary or binary_compressed."""
    h, w, _ = xyz.shape
    n = h * w
    pts = np.ascontiguousarray(xyz, np.float32).reshape(n, 3)
    packed = np.zeros(n, np.uint32)
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\nFIELDS x y z rgb\n"
              "SIZE 4 4 4 4\nTYPE F F F U\nCOUNT 1 1 1 1\n"
              f"WIDTH {w}\nHEIGHT {h}\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA {kind}\n")
    if kind == "ascii":
        lines = [f"{x!r} {y!r} {z!r} {c}" for (x, y, z), c in
                 zip(pts.astype(np.float64).tolist(), packed.tolist())]
        body = ("\n".join(lines) + "\n").encode()
    elif kind == "binary":
        rec = np.empty(n, np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("rgb", "<u4")]))
        rec["x"], rec["y"], rec["z"], rec["rgb"] = pts[:, 0], pts[:, 1], pts[:, 2], packed
        body = rec.tobytes()
    elif kind == "binary_compressed":
        raw = b"".join([np.ascontiguousarray(pts[:, i]).astype("<f4").tobytes()
                        for i in range(3)] + [packed.astype("<u4").tobytes()])
        comp = lzf_literal(raw)
        body = struct.pack("<II", len(comp), len(raw)) + comp
    else:
        raise ValueError(f"unsupported PCD DATA kind: {kind}")
    with open(path, "wb") as f:
        f.write(header.encode() + body)
