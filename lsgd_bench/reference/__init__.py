"""Plain PyTorch reference of what a cell's timed path computes: the
decoder's loss and gradients (one file a mixer or FFN kind, found by the
kind's name), SGD with Nesterov momentum, and the global sync.

It imports nothing of the program: it is handed the benchmark's weights
and tokens and works everything else out again.  Weights are a dict of
named tensors, stacked over the layer pattern's repeats, named as
``lm.param_shapes`` lists them.
"""
