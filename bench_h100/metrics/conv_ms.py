"""conv_ms: device ms a step of the kernels launched under an aten
convolution op, forward and backward."""


def read(ctx):
    return ctx["trace"].layer_ms_per_step("conv")
