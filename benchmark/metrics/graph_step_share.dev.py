"""``graph_step_share``'s reading, in the cells judged by the device's time
a step (``train_step_device_ms``), as ``graph_step_share`` is read in those
judged by the wall rate: there IGCNTrainer's steps bypass the graph and
read 0.0."""

from benchmark.run import reader

read = reader("graph_step_share")
