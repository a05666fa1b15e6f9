"""Device milliseconds a train step spends in the span ``train.update`` of
``DetectionTrainer.train_step``: ``TrainState.apply_gradients``: the clip
by the global norm (with its host read), the SGD update and the EMA; from
its entry to its exit on the stream, over the profiled stretch, divided by
its steps."""

from gpubench import spans


def read(run):
    return spans.device_ms_per_step(run, "train", "train.update")
