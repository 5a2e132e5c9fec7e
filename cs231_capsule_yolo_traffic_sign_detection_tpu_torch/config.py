"""Static configuration constants (PyTorch port).

The part of the JAX package's jax-free ``config.py`` that the port
uses, copied: the port imports no module of the JAX package.
"""

model_names = ["cnn", "capsule", "darknet_d", "darknet_r", "darkcapsule"]

GTSRB = "data/GTSRB"
GTSDB = "data/GTSDB"

# data file names (reference config.py:9-15)
tr_d = "/train.p"
ev_d = "/eval.p"
tr_sm_d = "/train_small.p"
ev_sm_d = "/eval_small.p"

data_dir = {
    "cnn": GTSRB,
    "capsule": GTSRB,
    "darknet_d": GTSDB,
    "darknet_r": GTSDB,
    "darkcapsule": GTSDB,
}

model_dir = {
    "cnn": "experiments/cnn",
    "capsule": "experiments/capsule",
    "darknet_d": "experiments/darknet_d",
    "darknet_r": "experiments/darknet_r",
    "darkcapsule": "experiments/darkcapsule",
}

# maximum number of samples used for the train/eval metric
# (reference config.py:53)
max_metric_samples = 1000

# plot colours (JAX config.py:58-64, the reference's config.py:45-50)
colors = [
    "#1f77b4", "#aec7e8", "#ff7f0e", "#ffbb78", "#2ca02c",
    "#98df8a", "#d62728", "#ff9896", "#9467bd", "#c5b0d5",
    "#8c564b", "#c49c94", "#e377c2", "#f7b6d2", "#7f7f7f",
    "#c7c7c7", "#bcbd22", "#dbdb8d", "#17becf", "#9edae5",
]
