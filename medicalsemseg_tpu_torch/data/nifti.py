"""Self-contained NIfTI-1 reader/writer (nibabel replacement).

The reference delegates all NIfTI IO to nibabel (reference: engine/test.py:83-89,
majority_vote.py:9-15). This module implements the NIfTI-1 format directly on
NumPy: 348-byte header, optional gzip container, scl slope/intercept scaling,
sform/qform affines, plus the RAS reorientation MONAI's Orientationd performs.

Volumes are returned in Fortran (x fastest) axis order as (X, Y, Z[, T])
arrays like nibabel's get_fdata, with the 4x4 voxel-to-world affine.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple, Union

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HDR_SIZE = 348


@dataclass
class NiftiImage:
    data: np.ndarray
    affine: np.ndarray  # 4x4 voxel -> world (RAS+ mm)

    @property
    def shape(self):
        return self.data.shape

    def get_fdata(self) -> np.ndarray:
        return np.asarray(self.data, dtype=np.float64)


def _maybe_gzip_open(path: Union[str, Path], mode: str):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _quaternion_affine(hdr: dict) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
        [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
        [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
    ])
    pixdim = hdr["pixdim"]
    qfac = -1.0 if pixdim[0] == -1.0 else 1.0
    zooms = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R * zooms
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def _parse_header(raw: bytes) -> dict:
    if len(raw) < HDR_SIZE:
        raise ValueError("truncated NIfTI header")
    sizeof_hdr = struct.unpack("<i", raw[0:4])[0]
    endian = "<"
    if sizeof_hdr != HDR_SIZE:
        sizeof_hdr = struct.unpack(">i", raw[0:4])[0]
        if sizeof_hdr != HDR_SIZE:
            raise ValueError("not a NIfTI-1 file")
        endian = ">"

    def u(fmt, off):
        return struct.unpack(endian + fmt, raw[off:off + struct.calcsize(fmt)])

    hdr = {
        "endian": endian,
        "dim": u("8h", 40),
        "datatype": u("h", 70)[0],
        "bitpix": u("h", 72)[0],
        "pixdim": u("8f", 76),
        "vox_offset": u("f", 108)[0],
        "scl_slope": u("f", 112)[0],
        "scl_inter": u("f", 116)[0],
        "qform_code": u("h", 252)[0],
        "sform_code": u("h", 254)[0],
        "quatern_b": u("f", 256)[0],
        "quatern_c": u("f", 260)[0],
        "quatern_d": u("f", 264)[0],
        "qoffset_x": u("f", 268)[0],
        "qoffset_y": u("f", 272)[0],
        "qoffset_z": u("f", 276)[0],
        "srow_x": u("4f", 280),
        "srow_y": u("4f", 296),
        "srow_z": u("4f", 312),
        "magic": raw[344:348],
    }
    return hdr


def load(path: Union[str, Path]) -> NiftiImage:
    """Read a .nii / .nii.gz file."""
    with _maybe_gzip_open(path, "rb") as f:
        raw = f.read()
    hdr = _parse_header(raw[:HDR_SIZE])

    ndim = hdr["dim"][0]
    shape = tuple(int(s) for s in hdr["dim"][1:1 + max(ndim, 1)])
    shape = tuple(max(s, 1) for s in shape)
    dtype = np.dtype(_DTYPES[hdr["datatype"]]).newbyteorder(hdr["endian"])
    offset = int(hdr["vox_offset"])
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    data = data.reshape(shape, order="F")

    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    if slope not in (0.0, 1.0) or inter != 0.0:
        if slope == 0.0:
            slope = 1.0
        data = data.astype(np.float32) * slope + inter
    else:
        data = np.asarray(data)

    if hdr["sform_code"] > 0:
        affine = np.eye(4)
        affine[0] = hdr["srow_x"]
        affine[1] = hdr["srow_y"]
        affine[2] = hdr["srow_z"]
    elif hdr["qform_code"] > 0:
        affine = _quaternion_affine(hdr)
    else:
        affine = np.diag([hdr["pixdim"][1], hdr["pixdim"][2],
                          hdr["pixdim"][3], 1.0])
    return NiftiImage(data=data, affine=affine)


def save(img: NiftiImage, path: Union[str, Path]) -> None:
    """Write a .nii / .nii.gz with an sform affine."""
    data = np.asarray(img.data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[data.dtype]
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)

    hdr = bytearray(HDR_SIZE)
    struct.pack_into("<i", hdr, 0, HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    zooms = np.sqrt((np.asarray(img.affine)[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, *zooms, *([1.0] * (7 - 3)))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code: scanner
    struct.pack_into("<4f", hdr, 280, *np.asarray(img.affine)[0])
    struct.pack_into("<4f", hdr, 296, *np.asarray(img.affine)[1])
    struct.pack_into("<4f", hdr, 312, *np.asarray(img.affine)[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    with _maybe_gzip_open(path, "wb") as f:
        f.write(payload)


def io_orientation(affine: np.ndarray) -> np.ndarray:
    """(3, 2) array mapping input axes -> (output axis, flip) (nibabel algo)."""
    rzs = np.asarray(affine, dtype=np.float64)[:3, :3]
    zooms = np.sqrt((rzs ** 2).sum(axis=0))
    zooms[zooms == 0] = 1.0
    rs = rzs / zooms
    p, s, qs = np.linalg.svd(rs)
    tol = s.max() * 3 * np.finfo(np.float64).eps
    keep = s > tol
    r = p[:, keep] @ qs[keep]
    ornt = np.full((3, 2), np.nan)
    for in_ax in range(3):
        col = r[:, in_ax]
        if np.allclose(col, 0):
            continue
        out_ax = int(np.argmax(np.abs(col)))
        ornt[in_ax, 0] = out_ax
        ornt[in_ax, 1] = 1.0 if col[out_ax] > 0 else -1.0
        r[out_ax, :] = 0
    return ornt


def to_ras(data: np.ndarray, affine: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Reorient (X, Y, Z[, C]) voxels + affine to RAS+ axis order.

    MONAI Orientationd(axcodes='RAS') equivalent.
    """
    ornt = io_orientation(affine)
    shape3 = data.shape[:3]

    out = data
    # flip axes with negative direction
    for in_ax in range(3):
        if ornt[in_ax, 1] == -1:
            out = np.flip(out, axis=in_ax)
    # permute so input axis in_ax lands at output axis ornt[in_ax, 0]
    perm = np.argsort(ornt[:, 0]).astype(int)  # output axis -> input axis
    axes = list(perm) + list(range(3, out.ndim))
    out = np.transpose(out, axes)

    # rebuild the affine: undo the same ops on the transform
    t = np.eye(4)
    for in_ax in range(3):
        if ornt[in_ax, 1] == -1:
            t_flip = np.eye(4)
            t_flip[in_ax, in_ax] = -1
            t_flip[in_ax, 3] = shape3[in_ax] - 1
            t = t @ t_flip
    t_perm = np.zeros((4, 4))
    t_perm[3, 3] = 1
    for out_ax, in_ax in enumerate(perm):
        t_perm[in_ax, out_ax] = 1
    new_affine = affine @ t @ t_perm
    return np.ascontiguousarray(out), new_affine
