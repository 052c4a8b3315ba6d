"""The port's kernel launches inside each traced tick's
``cptorch.serve.step`` span, counted by the port's own store of spans
(``contrastiveprosthetics_torch/utils/spans.py``, the difference of
``ops/kernels.py::launch_counts`` between the span's edges), the mean over
the traced ticks. None where the port has no such store or span."""
STEP = "cptorch.serve.step"


def read(obs):
    n = obs["trace_ticks"]
    if not n:
        return None
    try:
        from contrastiveprosthetics_torch.utils import spans
    except ImportError:
        return None
    return spans.launches(STEP, last=n)
