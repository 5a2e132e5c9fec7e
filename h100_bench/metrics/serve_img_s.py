"""serve_img_s: every image whose outputs reached the host in the
window, over the window's seconds.  Host clock."""


def read(ctx):
    return ctx.window.images / ctx.window.seconds
