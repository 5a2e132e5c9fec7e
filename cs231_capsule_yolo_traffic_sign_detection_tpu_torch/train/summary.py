"""Model summary: parameter names, shapes and counts (counterpart of the
JAX train/summary.py, over an ``nn.Module``).

Replaces the reference's torchsummary startup printout (reference
main.py:270-271).
"""


def summarize(model, title="Model"):
    """Print one row per parameter and the total; returns the total."""
    rows = [(name, tuple(p.shape), p.numel())
            for name, p in model.named_parameters()]
    total = sum(n for _, _, n in rows)
    width = max([len(r[0]) for r in rows] + [10])
    rule = "-" * (width + 30)
    lines = [rule, f"{title} parameter summary", rule]
    for name, shape, n in rows:
        lines.append(f"{name:<{width}}  {str(shape):<18} {n:>10,}")
    lines += [rule, f"Trainable params: {total:,}", rule]
    print("\n".join(lines))
    return total
