"""Minimal NIfTI-1 reader/writer (no nibabel/SimpleITK dependency); the
port's own copy of ``rsuper_tpu/data/nifti.py`` on its numpy path (the native
decoder is host code that a later slice may port).

The reference leans on SimpleITK / nibabel for all volume IO
(``rsuper_train/dataset_conversion/abdomenatlas_3d.py``,
``predict_abdomenatlas.py:325``); neither ships in this environment, so the
format is implemented directly: a 348-byte little-endian header + raw voxels
(optionally gzipped), Fortran voxel order (x fastest).

Supports: .nii / .nii.gz, the common datatypes, scl slope/inter scaling,
sform/qform affines, and canonical RAS+ reorientation (the equivalent of the
reference's DICOM-orient step — see `as_canonical`).
"""

from __future__ import annotations

import dataclasses
import gzip
import struct
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class NiftiImage:
    """Voxel array in (x, y, z) index order + 4x4 voxel→world affine (RAS mm)."""

    data: np.ndarray
    affine: np.ndarray

    @property
    def spacing(self) -> np.ndarray:
        return np.linalg.norm(self.affine[:3, :3], axis=0)

    def orientation(self) -> Tuple[str, str, str]:
        """Axis codes, e.g. ('R', 'A', 'S'): the world direction each voxel
        axis mostly points toward."""
        labels = (("L", "R"), ("P", "A"), ("I", "S"))
        codes = []
        M = self.affine[:3, :3]
        for ax in range(3):
            col = M[:, ax]
            w = int(np.argmax(np.abs(col)))
            codes.append(labels[w][1] if col[w] > 0 else labels[w][0])
        return tuple(codes)


def _quaternion_affine(hdr) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    qfac = -1.0 if hdr["pixdim0"] < 0 else 1.0
    S = np.diag([hdr["pixdim1"], hdr["pixdim2"], hdr["pixdim3"] * qfac])
    A = np.eye(4)
    A[:3, :3] = R @ S
    A[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return A


def _read_header(raw: bytes) -> dict:
    if len(raw) < 348:
        raise ValueError("truncated NIfTI header")
    (sizeof_hdr,) = struct.unpack("<i", raw[0:4])
    if sizeof_hdr != 348:
        raise ValueError(f"not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    dim = struct.unpack("<8h", raw[40:56])
    datatype, bitpix = struct.unpack("<2h", raw[70:74])
    pixdim = struct.unpack("<8f", raw[76:108])
    (vox_offset,) = struct.unpack("<f", raw[108:112])
    scl_slope, scl_inter = struct.unpack("<2f", raw[112:120])
    qform_code, sform_code = struct.unpack("<2h", raw[252:256])
    qb, qc, qd, qx, qy, qz = struct.unpack("<6f", raw[256:280])
    srow = np.array(struct.unpack("<12f", raw[280:328])).reshape(3, 4)
    magic = raw[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"bad NIfTI magic {magic!r}")
    return dict(
        dim=dim, datatype=datatype, bitpix=bitpix, pixdim=pixdim,
        vox_offset=int(vox_offset), scl_slope=scl_slope, scl_inter=scl_inter,
        qform_code=qform_code, sform_code=sform_code,
        quatern_b=qb, quatern_c=qc, quatern_d=qd,
        qoffset_x=qx, qoffset_y=qy, qoffset_z=qz,
        pixdim0=pixdim[0], pixdim1=pixdim[1], pixdim2=pixdim[2],
        pixdim3=pixdim[3], srow=srow,
    )


def read_nifti(path: str, dtype=None) -> NiftiImage:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    hdr = _read_header(raw)
    ndim = hdr["dim"][0]
    shape = tuple(max(1, hdr["dim"][1 + i]) for i in range(min(ndim, 3)))
    np_dtype = _DTYPES.get(hdr["datatype"])
    if np_dtype is None:
        raise ValueError(f"unsupported NIfTI datatype {hdr['datatype']}")
    count = int(np.prod(shape))
    off = max(hdr["vox_offset"], 348)
    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    data = np.frombuffer(raw, dtype=np.dtype(np_dtype).newbyteorder("<"),
                         count=count, offset=off)
    data = data.reshape(shape, order="F")
    if slope not in (0.0, 1.0) or inter != 0.0:
        data = data * (slope if slope != 0 else 1.0) + inter
    if dtype is not None:
        data = data.astype(dtype)
    else:
        data = np.asarray(data)

    if hdr["sform_code"] > 0:
        affine = np.eye(4)
        affine[:3, :] = hdr["srow"]
    elif hdr["qform_code"] > 0:
        affine = _quaternion_affine(hdr)
    else:
        affine = np.diag([hdr["pixdim1"], hdr["pixdim2"], hdr["pixdim3"], 1.0])
    return NiftiImage(data=data, affine=affine)


def write_nifti(path: str, data: np.ndarray, affine: Optional[np.ndarray] = None):
    """Write a 3D array (x, y, z order) as NIfTI-1 (.nii or .nii.gz)."""
    if affine is None:
        affine = np.eye(4)
    data = np.asarray(data)  # written in Fortran order by tobytes below
    code = _DTYPE_CODES.get(np.dtype(data.dtype))
    if code is None:
        data = data.astype(np.float32)
        code = 16
    spacing = np.linalg.norm(affine[:3, :3], axis=0)

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into("<2h", hdr, 70, code, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform, sform
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].ravel())
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    if str(path).endswith(".gz"):
        # level 1, nibabel's default for .nii.gz: the same bytes when read
        # back, at several times the speed of gzip's level 9
        f = gzip.open(path, "wb", compresslevel=1)
    else:
        f = open(path, "wb")
    with f:
        f.write(payload)


def as_canonical(img: NiftiImage) -> NiftiImage:
    """Reorient to RAS+ (axis permutation + flips only — no resampling).

    Equivalent role to the reference's reorientation step
    (``dataset_conversion/utils.py:38`` ``reorient_image``); the canonical
    frame here is RAS+ (nibabel convention).
    """
    M = img.affine[:3, :3]
    # assign each voxel axis to the world axis it most aligns with
    perm = [-1, -1, -1]
    flips = [False, False, False]
    remaining = {0, 1, 2}
    for ax in range(3):
        col = M[:, ax]
        w = max(remaining, key=lambda r: abs(col[r]))
        remaining.discard(w)
        perm[w] = ax
        flips[w] = col[w] < 0
    data = np.transpose(img.data, perm)
    P = np.zeros((4, 4))
    P[3, 3] = 1
    for w, ax in enumerate(perm):
        P[ax, w] = 1
    affine = img.affine @ P
    for w in range(3):
        if flips[w]:
            data = np.flip(data, axis=w)
            affine[:3, 3] = affine[:3, 3] + affine[:3, w] * (data.shape[w] - 1)
            affine[:3, w] = -affine[:3, w]
    return NiftiImage(data=np.ascontiguousarray(data), affine=affine)
