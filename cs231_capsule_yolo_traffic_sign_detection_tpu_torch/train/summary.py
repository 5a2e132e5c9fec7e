"""Model summary: parameter names, shapes and counts (counterpart of the
JAX train/summary.py, over an ``nn.Module``).

Replaces the reference's torchsummary startup printout (reference
main.py:270-271).
"""


def summarize(model, title="Model"):
    """Print one row per parameter, the count that trains and, when
    fine-tuning froze some, the count frozen; returns the count that
    trains."""
    rows = [(name, tuple(p.shape), p.numel(), p.requires_grad)
            for name, p in model.named_parameters()]
    trainable = sum(n for _, _, n, train in rows if train)
    frozen = sum(n for _, _, n, train in rows if not train)
    width = max([len(r[0]) for r in rows] + [10])
    rule = "-" * (width + 30)
    lines = [rule, f"{title} parameter summary", rule]
    for name, shape, n, train in rows:
        lines.append(f"{name:<{width}}  {str(shape):<18} {n:>10,}"
                     + ("" if train else "  frozen"))
    lines += [rule, f"Trainable params: {trainable:,}"]
    if frozen:
        lines.append(f"Frozen params: {frozen:,}")
    lines.append(rule)
    print("\n".join(lines))
    return trainable
