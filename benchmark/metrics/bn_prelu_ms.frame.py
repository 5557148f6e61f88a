"""Device time of K3's PReLU route (the kernels named ``bn_prelu_kernel``:
ArcFace IResNet's BatchNorm and PReLU) per traced frame (ms), per-frame
path.  Nothing where the program has no such kernel."""

NAME = "bn_prelu_kernel"


def read(r):
    t = r.get("trace")
    if r["mode"] != "per_frame" or not t or not t.get("frames"):
        return None
    s = [v for k, v in t["kernel_s"].items() if NAME in k]
    return 1e3 * sum(s) / t["frames"] if s else None
