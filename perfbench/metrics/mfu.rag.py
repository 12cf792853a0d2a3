"""The whole served step's share of the H100's bf16 peak: the matmul
FLOPs of the prompt and output tokens processed in the window, each
request at its own lengths (``roofline.request_flops``), prompt FLOPs
spread over [send, first token] and output FLOPs over [first token, done],
per second, over 989 TFLOP/s."""

from perfbench.harness import roofline
from perfbench.harness.window import prorated


def read(run):
    c = run.cfg
    shape = {"hidden": c["hidden_size"], "layers": c["num_hidden_layers"],
             "heads": c["num_attention_heads"], "kv_heads": c["num_key_value_heads"],
             "mlp_dim": c["intermediate_size"], "vocab": c["vocab_size"]}
    total = 0.0
    for r in run.records:
        if not r.ok or r.t_first is None:
            continue
        p, o = roofline.request_flops(shape, r.req["prompt_tokens"], r.n_out)
        total += prorated(p, r.t_send, r.t_first, run.w0, run.w1)
        total += prorated(o, r.t_first, r.t_done, run.w0, run.w1)
    return 100.0 * total / run.seconds / roofline.PEAK["bf16"]
