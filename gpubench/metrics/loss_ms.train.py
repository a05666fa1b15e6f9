"""Device milliseconds a train step spends in the span ``train.loss`` of
``DetectionTrainer.train_step``: the loss (the task-aligned assignment,
the box and class terms, the MoE aux loss); from its entry to its exit on
the stream, over the profiled stretch, divided by its steps."""

from gpubench import spans


def read(run):
    return spans.device_ms_per_step(run, "train", "train.loss")
