"""Plain references of what the timed path computes, in plain torch.

Frozen copies of the port's plain spellings where the comparison needs the
kernels' order of operations (the Philox stream, the EKF rollout, the
simulator's streams and the graph assembly), and a dense float64
Gauss-Newton solve of the assembled graphs. They import nothing of the
program and take nothing it made: they work their inputs out again from
the seed and the configuration.
"""
