"""The cells cut to sizes the CPU runs in seconds, for the CPU tests:
the same configurations and mixes with their scale reduced (the port's
kernels take their plain versions on CPU tensors)."""

from h100_bench import harness

SMALL = {
    "darknet_r": {"darknet_input": 64, "n_grid": 2, "batch_size": 4},
    "capsule": {"batch_size": 4, "device": "cpu"},
    "serve_frames": {"frame_hw": [96, 160], "pool": 8,
                     "calibration_frames": 4},
    "serve_crops": {"pool": 16},
    "train_crops": {"n": 16},
    "train_scenes": {"n": 16},
}
SEED = 2 ** 31 + 12345


def small_cell(name):
    cell = harness.Cell(harness.load_spec(), name)
    cell.config.update(SMALL[cell.entry["config"]])
    cell.traffic.update(SMALL[cell.entry["traffic"]])
    return cell
