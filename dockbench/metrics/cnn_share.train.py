"""Share (%) of the device's busy time spent in convolution kernels,
forward and backward (data and weight gradients): the device time under
the outermost convolution ops and their autograd nodes."""

OPS = ("aten::conv3d", "aten::convolution", "aten::convolution_backward",
       "ConvolutionBackward0")


def read(t):
    s = t.op_s(OPS)
    if t.busy_s <= 0 or s <= 0:
        return None
    return 100.0 * s / t.busy_s
