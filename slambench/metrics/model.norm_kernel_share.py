"""model.norm_kernel_share: the share of the model's bf16 LayerNorms on the
card that ran the one-pass kernel, over the program's model.inference spans
after the slice: Σ norms_kernel ÷ Σ (norms_kernel + norms_eager), in %.  None
where no model.inference span carries the counts (a program older than the
kernel) or where the spans ran no bf16 norm on the card (the CPU)."""
from slambench.lib.program_spans import steady_records


def read(run):
    recs = steady_records(run)
    if recs is None:
        return None
    spans = [r.attrs for r in recs if r.name == "model.inference" and "norms_kernel" in r.attrs]
    kernel = sum(a["norms_kernel"] for a in spans)
    total = kernel + sum(a.get("norms_eager", 0) for a in spans)
    return 100.0 * kernel / total if total else None
