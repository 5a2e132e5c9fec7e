"""mfu.train: the model's FLOPs of the train steps in the traced window
(forward and backward: work.py's count from the configuration's shapes,
three times the forward less the first layer's input gradient) over the
window's seconds and the card's f32 peak (165 TFLOP/s, 3xTF32), in
percent."""

from h100_bench.work import F32_PEAK_FLOP_S


def read(ctx):
    return (ctx.flop_per_image * ctx.window.images
            / (ctx.trace.window_s * F32_PEAK_FLOP_S) * 100)
