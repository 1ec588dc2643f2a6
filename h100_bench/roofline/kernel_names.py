"""The port's kernels as the device trace names them, reduced to their function
names, and the device time of a set of them in a traced run's record."""

import re

ROW1 = ("gram_kernel", "density_parent_kernel", "density_rows_kernel",
        "parent_rows_kernel")
# csrc/fused_sublayer.cu and fused_bert_attention_int8.cu: the row passes,
# the wgmma GEMM, the attention and the hidden quantisation
INT8 = ("quant_rows_kernel", "rows_kernel", "wgmma_gemm_kernel",
        "attn_mma_kernel", "hidden_quant_kernel")


def base_name(name: str) -> str:
    """'void (anonymous namespace)::attn_mma_kernel<...>(...)' ->
    'attn_mma_kernel'."""
    s = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    m = re.match(r"[\w:]+", s)
    return m.group(0).split("::")[-1] if m else name


def device_us(rec, names) -> float:
    return sum(d for n, _, d in rec["kernels"] if base_name(n) in names)
