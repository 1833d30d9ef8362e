"""GluonCV pretrained weights into the port (counterpart of
torchseg_tpu/utils/gluon_convert.py).

Mirrors the role of the reference's ``furnace/tools/gluon2pytorch.py``
(:34-42): GluonCV is where the v1c deep-stem ResNets ship from, and the
conversion is a pure rename — BatchNorm ``gamma``/``beta`` become
``weight``/``bias`` while every structural name (``conv1.0``, ``layer3.5``,
``downsample.0``) already matches the torch layout.  The renamed dict then
rides the reference-checkpoint machinery (utils/torch_convert.py).

Unlike the reference (which hard-requires ``mxnet``), the ``.params`` file
is read with a pure-numpy parser for the MXNet NDArray container format —
``mxnet.nd.load`` is used instead when the package is importable.  The
parser covers the dense-tensor V1/V2/V3 records GluonCV checkpoints use
(magic 0x112 list header; per-array magic 0xF993FAC8/9/A).
"""

import struct
from typing import Dict

import numpy as np

from ..engine.logger import get_logger

_LIST_MAGIC = 0x112
_ND_V1 = 0xF993FAC8  # shape saved as uint32 dims
_ND_V2 = 0xF993FAC9  # V1 + int32 storage-type field
_ND_V3 = 0xF993FACA  # V2 with int64 ndim/dims (large-tensor builds)

# mshadow type_flag -> numpy dtype (mshadow/base.h)
_DTYPES = {
    0: np.float32, 1: np.float64, 2: np.float16,
    3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64,
}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def bytes(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated .params file")
        self.pos += n
        return out


def _read_ndarray(r: _Reader) -> np.ndarray:
    magic = r.take("I")
    if magic not in (_ND_V1, _ND_V2, _ND_V3):
        raise ValueError(
            f"unrecognized NDArray record magic 0x{magic:x} — not a dense "
            "GluonCV tensor (sparse arrays are not used by the v1c "
            "checkpoints this converter targets)"
        )
    if magic in (_ND_V2, _ND_V3):
        stype = r.take("i")
        if stype not in (-1, 0):  # kUndefinedStorage / kDefaultStorage
            raise ValueError(f"unsupported storage type {stype} (sparse)")
    wide = magic == _ND_V3  # int64 ndim + dims
    ndim = r.take("q" if wide else "I")
    if not 0 <= ndim <= 32:
        raise ValueError(f"implausible ndim {ndim} — parser/format mismatch")
    shape = tuple(
        r.take("q" if wide else "I") for _ in range(ndim)
    )
    dev_type, _dev_id, type_flag = r.take("iii")
    if dev_type not in (1, 2, 3, 5):  # cpu/gpu/cpu_pinned/cpu_shared
        raise ValueError(f"implausible device type {dev_type}")
    if type_flag not in _DTYPES:
        raise ValueError(f"unknown dtype flag {type_flag}")
    dtype = np.dtype(_DTYPES[type_flag])
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    data = r.bytes(n * dtype.itemsize)
    return np.frombuffer(data, dtype=dtype).reshape(shape).copy()


def parse_mxnet_params(buf: bytes) -> Dict[str, np.ndarray]:
    """Parse an ``mx.nd.save``-format blob (what ``save_parameters`` and the
    GluonCV model zoo produce) into {name: array} with pure numpy."""
    r = _Reader(buf)
    magic, reserved = r.take("QQ")
    if magic != _LIST_MAGIC:
        raise ValueError(
            f"bad .params header magic 0x{magic:x} (expected 0x112) — "
            "is this an MXNet NDArray file?"
        )
    n_arrays = r.take("Q")
    arrays = [_read_ndarray(r) for _ in range(n_arrays)]
    n_keys = r.take("Q")
    keys = [r.bytes(r.take("Q")).decode() for _ in range(n_keys)]
    if n_keys and n_keys != n_arrays:
        raise ValueError(f"{n_arrays} arrays but {n_keys} names")
    if not keys:
        keys = [str(i) for i in range(len(arrays))]
    return dict(zip(keys, arrays))


def load_gluon_params(path: str) -> Dict[str, np.ndarray]:
    """Read a GluonCV ``.params`` checkpoint: via mxnet when importable
    (exactly the reference's ``mx.nd.load``), else the numpy parser."""
    try:
        import mxnet as mx  # noqa: F401

        return {k: v.asnumpy() for k, v in mx.nd.load(path).items()}
    except ImportError:
        with open(path, "rb") as f:
            return parse_mxnet_params(f.read())


def gluon_to_torch_state_dict(
    gluon_params: Dict[str, np.ndarray],
) -> Dict[str, np.ndarray]:
    """The reference conversion (gluon2pytorch.py:34-42): strip the
    ``arg:``/``aux:`` prefixes mx.nd.save adds to raw-symbol dicts, rename
    BN gamma/beta -> weight/bias.  running_mean/running_var already match."""
    out = {}
    for key, value in gluon_params.items():
        if ":" in key:
            key = key.split(":", 1)[1]
        if "gamma" in key:
            key = key.replace("gamma", "weight")
        elif "beta" in key:
            key = key.replace("beta", "bias")
        out[key] = np.asarray(value)
    return out


def graft_gluon_backbone(path_or_dict, model, subtree: str = "backbone"):
    """Graft a GluonCV ResNet (v1b/v1c) checkpoint under
    ``model.<subtree>``, in place: .params -> torch-style names ->
    convert_resnet_state_dict -> non-strict graft with key logging (the
    end-to-end role of gluon2pytorch and the reference's pretrained load,
    pyt_utils.load_model:42-79); returns the model."""
    from .torch_convert import convert_resnet_state_dict, graft_backbone

    gluon = (load_gluon_params(path_or_dict)
             if isinstance(path_or_dict, str) else dict(path_or_dict))
    sd = gluon_to_torch_state_dict(gluon)
    src_params, src_stats = convert_resnet_state_dict(sd)
    get_logger().info(
        "grafting %d gluon tensors into %s", len(sd), subtree
    )
    return graft_backbone(model, src_params, src_stats, subtree)


def save_mxnet_params(path: str, params: Dict[str, np.ndarray]) -> str:
    """Write {name: array} in the same container format (V2 dense records)
    — the fixture generator for round-trip tests, and a convenience for
    exporting back toward gluon tooling."""
    rev = {v: k for k, v in _DTYPES.items()}
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(params)))
        for arr in params.values():
            arr = np.ascontiguousarray(arr)
            if arr.dtype.type not in rev:
                raise ValueError(f"unsupported dtype {arr.dtype}")
            f.write(struct.pack("<Ii", _ND_V2, 0))
            f.write(struct.pack("<I", arr.ndim))
            f.write(struct.pack(f"<{arr.ndim}I", *arr.shape))
            f.write(struct.pack("<iii", 1, 0, rev[arr.dtype.type]))
            f.write(arr.tobytes())
        f.write(struct.pack("<Q", len(params)))
        for name in params:
            b = name.encode()
            f.write(struct.pack("<Q", len(b)))
            f.write(b)
    return path
