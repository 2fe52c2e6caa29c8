"""The port's command-line scripts (counterparts of the JAX package's
`scripts/`): the demos and the attribution of their errors, the promotion
gate, the dashboards and the data viewer. Each runs as
`python -m autoposeestimation_tpu_torch.scripts.<name>` and writes its
outputs under the directory it is given."""
