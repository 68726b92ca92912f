"""img_per_s: images whose rgb reached the host within the window, over
the window's seconds."""


def read(rec):
    return rec["images_in_window"] / rec["window_s"]
