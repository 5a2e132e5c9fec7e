"""mfu.serve: the model's FLOPs of the images served in the traced
window (direct convolutions and the routing's products, counted from
the configuration's shapes in work.py) over the window's seconds and
the card's f32 peak (165 TFLOP/s, 3xTF32), in percent."""

from h100_bench.work import F32_PEAK_FLOP_S


def read(ctx):
    return (ctx.flop_per_image * ctx.window.images
            / (ctx.trace.window_s * F32_PEAK_FLOP_S) * 100)
