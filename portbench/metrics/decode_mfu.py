"""Model FLOPs of the decode chunks started in the window over their wall
time, as a share of the card's bf16 peak: each live row's tokens at their
cached positions, counted by the architecture's ``token_flops``
(``portbench/arch/<model_type>.py``)."""

from portbench import roofline
from portbench.window import spans


def read(run):
    chunks = spans(run, "decode_chunk")
    if not chunks:
        return None
    flops = sum(run.arch.token_flops(run.config, pos + s)
                for _, _, f in chunks for pos in f["lengths"] for s in range(f["steps"]))
    wall = sum(t1 - t0 for t0, t1, _ in chunks)
    return 100.0 * flops / wall / roofline.PEAK_BF16
