"""The sweep's convolutions as a share (%) of their roofline: the least
time of the traced requests' sweep convolutions over the device time
under their spans.

Work, from the cell's configuration and each traced request's ligand
box, as ``dock_mfu`` counts it: every chunk holds ``rotation_chunk``
rotated ligands (the sweep pads the last one), each a box^3 grid; a
layer of C_in -> C_out channels does 2 C_out C_in k^3 operations a
voxel and moves its input and output once a voxel and its kernel once a
chunk, at the compute dtype's width (biases, under a millionth of the
bytes, left out).  With a rank-r coupling folded into the last layer
(``coupling_rank`` below the channels) that layer has r outputs.  A
layer's least time is the larger of its bytes at HBM speed and its
operations at the peak of the precision cuDNN runs it in: bf16 at 989
TFLOP/s; float32 under torch's default ``cudnn.allow_tf32`` as TF32,
dense, at 495 TFLOP/s.

Device time: the kernels linked to torch's operators under the
program's ``dlpd::cnn.conv<i>`` spans inside ``dlpd::sweep.cnn`` (the
convolution, its layout copies and its activation; ``lib/linked.py``).
Nothing is read where the program has no such spans.
"""
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from lib.linked import linked_s  # noqa: E402
from lib.peaks import HBM_BYTES_PER_S  # noqa: E402

CONV_PEAK = {"bfloat16": 989e12, "float32": 495e12}
ITEMSIZE = {"bfloat16": 2, "float32": 4}
MAX_LAYERS = 16


def layers(cfg) -> list:
    """``(C_in, C_out)`` of each layer of the sweep's ligand CNN."""
    widths = [cfg["num_atom_types"]] + list(cfg["rep_features"])
    C = widths[-1] + (2 if cfg["shape_prior"] else 0)
    r = cfg["coupling_rank"]
    if r is not None and r < C:
        widths[-1] = r
    return list(zip(widths[:-1], widths[1:]))


def request_work(cfg, rotations: int, box: int) -> list:
    """``(C_in, C_out, FLOPs, bytes)`` of each layer's convolutions in
    one request's sweep."""
    chunk = cfg["rotation_chunk"]
    chunks = math.ceil(rotations / chunk)
    voxels = chunks * chunk * box ** 3
    k3 = cfg["rep_kernel"] ** 3
    size = ITEMSIZE[cfg["compute_dtype"]]
    return [(a, b, 2 * voxels * k3 * a * b,
             size * (voxels * (a + b) + chunks * k3 * a * b))
            for a, b in layers(cfg)]


def request_bound_s(cfg, rotations: int, box: int) -> float:
    """Least seconds of one request's sweep convolutions."""
    peak = CONV_PEAK[cfg["compute_dtype"]]
    return sum(max(nbytes / HBM_BYTES_PER_S, flops / peak)
               for _, _, flops, nbytes in request_work(cfg, rotations, box))


def read(t):
    if not t.units:
        return None
    dev_s = linked_s(t, {f"dlpd::cnn.conv{i}" for i in range(MAX_LAYERS)},
                     under="dlpd::sweep.cnn")
    if dev_s <= 0:
        return None
    return 100.0 * sum(request_bound_s(t.cfg, u["rotations"], u["lig_box"])
                       for u in t.units) / dev_s
