"""mfu_pct: the configuration's convolution operations an image
(``benchmark/flops.py``, from the reference's layer shapes) times the
window's images a second, over the card's peak in the configuration's
precision (989 TFLOP/s bf16; 67 TFLOP/s float32 without TF32)."""

from benchmark.flops import PEAKS, conv_flops_per_image


def read(rec):
    if rec["device"]["platform"] != "gpu":
        return None
    config = rec["config"]
    img_s = rec["images_in_window"] / rec["window_s"]
    return 100.0 * conv_flops_per_image(config) * img_s / PEAKS[config["precision"]]
