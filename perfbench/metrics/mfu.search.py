"""The whole search step's share of the H100's peak: each query answered
in the window costs its BERT pass at its own length (the encoder's matmul
FLOPs, bf16 peak) and its int8 scan of ``nprobe`` lists at the index's mean
fill (int8 peak); the two times added, per second of window."""

from perfbench.harness import roofline
from perfbench.harness.window import in_window


def read(run):
    e, ix = run.cfg["encoder"], run.cfg["index"]
    rows = ix["nprobe"] * run.cfg["chunks"] / ix["nlist"]
    busy = 0.0
    for r in run.records:
        if r.ok and in_window(r.t_done, run.w0, run.w1):
            tokens = sum(1 for ch in r.req["query"] if not ch.isspace()) + 2
            busy += roofline.bert_flops(hidden=e["hidden_size"], layers=e["num_hidden_layers"],
                                        mlp_dim=e["intermediate_size"],
                                        seq_len=tokens) / roofline.PEAK["bf16"]
            busy += roofline.ivf_int8_ops(probed_rows=rows, d=e["hidden_size"]) / roofline.PEAK["int8"]
    return 100.0 * busy / run.seconds
