"""torch_glue_ms: device ms a step of every device operation that is
neither one of the port's ten kernels nor launched under a convolution
op: the plain-torch search geometry and top-K menu, the flows, softmax,
copies and fills."""


def read(ctx):
    return ctx["trace"].layer_ms_per_step("glue")
