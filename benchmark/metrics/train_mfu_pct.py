"""train_mfu_pct: the training step's model operations a trained image
(``benchmark/flops_train.py``, from the reference's layer shapes) times the
window's images a second, over the card's peak in the configuration's
precision (989 TFLOP/s bf16)."""

from benchmark.flops import PEAKS
from benchmark.flops_train import train_flops_per_image


def read(rec):
    if rec["device"]["platform"] != "gpu":
        return None
    config = rec["config"]
    img_s = rec["images_in_window"] / rec["window_s"]
    return 100.0 * train_flops_per_image(config) * img_s / PEAKS[config["precision"]]
