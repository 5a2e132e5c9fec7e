"""ReduceLROnPlateau — host-side LR state machine (PyTorch port).

A copy of the JAX package's jax-free train/plateau.py, so the port
imports nothing of that package.  The reference steps torch's
ReduceLROnPlateau on the TRAIN loss every epoch (reference main.py:164,
:174); this reproduces torch's semantics (mode='min', rel threshold
1e-4, patience 10, cooldown 0, min_lr 0): the LR is multiplied by
`factor` after `patience` epochs without an improvement better than
best*(1-threshold).  Its state is plain floats and ints, so it rides in
a checkpoint as the JAX driver keeps it.
"""


class ReduceLROnPlateau:
    def __init__(self, lr, factor=0.1, patience=10, threshold=1e-4,
                 cooldown=0, min_lr=0.0):
        self.lr = float(lr)
        self.factor = float(factor)
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def is_better(self, current):
        return current < self.best * (1.0 - self.threshold)

    def step(self, metric):
        current = float(metric)
        if self.is_better(current):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, d):
        self.__dict__.update(d)
