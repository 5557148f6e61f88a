"""The whole step's share of the card's bf16 peak (989 TFLOP/s): the
forward FLOPs the window's inputs need (the detector at its letterbox
for every frame, FaceNet-512 for every face encoded, at most ``encode_k``
a frame, and each of those faces against every gallery row) over the
measured window's seconds (%)."""

from harness.work import BF16_FLOP_PER_S

def read(r):
    w = r["work"]
    if r["mode"] != "batched" or r["window_s"] <= 0 or not w["frames"]:
        return None
    flops = 2.0 * (w["detector_macs"] * w["frames"] + w["encoder_macs"] * w["faces"]
                   + w["faces"] * w["gallery_rows"] * w["dim"])
    return 100.0 * flops / r["window_s"] / BF16_FLOP_PER_S
