"""train_img_s: every image of the train steps that ended in the window
(whole epochs), over the window's seconds.  Host clock."""


def read(ctx):
    return ctx.window.images / ctx.window.seconds
