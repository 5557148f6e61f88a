"""A cell's run on the CPU at a size a test can hold: small frames, a
small gallery, float32 networks, the program's own code underneath.  A
cell that ``BENCHMARK.json`` does not hold yet (the batched crowd, kept
for a later benchmark) runs from its configuration and traffic files."""

import time

TINY = {
    "per_frame": {
        "config": {"gallery_rows": 2000},
        "mix": {"frame_hw": [540, 960], "loop_frames": 24, "face_px": [100, 150],
                "check_items": 6, "trace_frames": 4, "slots": [3, 2]},
    },
    "batched": {
        "config": {"gallery_rows": 2000},
        "mix": {"frame_hw": [540, 960], "loop_frames": 16, "face_px": [100, 150],
                "check_items": 6, "trace_batches": 1, "batch_size": 8, "faces": [2, 4],
                "slots": [3, 2], "dwell": [4, 10]},
    },
}


def run_cpu(workload: str, seed: int = 2**31 + 11, seconds: float = 3.0, control=False,
            trace=False, config=None, mix=None):
    from harness import cell, spec

    bench = spec.load_benchmark()
    if workload not in {w["name"] for w in bench["workloads"]}:
        # a cell kept for later (<config>.<traffic>), added to a copy
        cfg_name, mix_name = workload.split(".", 1)
        bench["workloads"] = bench["workloads"] + [
            {"name": workload, "config": cfg_name, "traffic": mix_name, "chips": 1}]
    w = spec.cell(bench, workload)
    mode = spec.mix(w["traffic"])["mode"]
    cfg = spec.config(bench, w["config"])
    ov = {k: dict(v) for k, v in TINY[mode].items()}
    ov["config"]["input_px"] = [320, 320] if cfg["detector"] == "yunet" else [256, 256]
    ov["config"].update(config or {})
    ov["mix"].update(mix or {})
    ov["engine"] = {"compute_dtype": "float32"}
    return cell.run(workload, seed, seconds, trace, time.perf_counter(), device="cpu",
                    control=control, overrides=ov, bench=bench)
