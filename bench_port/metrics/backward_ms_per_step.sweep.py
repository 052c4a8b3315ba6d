"""The stacked step's backward on the card: the mean stream time between the
edges of the traced steps' ``cptorch.train.backward`` spans, from the CUDA
events the port's own store of spans records there
(``contrastiveprosthetics_torch/utils/spans.py``), in ms a step. It needs
no device record of the trace, which can drop some. None where the port
has no such store or span, or the span no events (the CPU)."""
SPAN = "cptorch.train.backward"


def read(obs):
    n = obs["traced_steps"]
    if not n:
        return None
    try:
        from contrastiveprosthetics_torch.utils import spans
    except ImportError:
        return None
    return spans.device_ms(SPAN, last=n)
