"""Device milliseconds a train step spends in the span ``train.forward`` of
``DetectionTrainer.train_step``: the model in train mode (the MoE levels'
routes and sweeps included); from its entry to its exit on the stream,
over the profiled stretch, divided by its steps."""

from gpubench import spans


def read(run):
    return spans.device_ms_per_step(run, "train", "train.forward")
