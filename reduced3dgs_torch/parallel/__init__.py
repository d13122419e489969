"""Multi-device training on torch.distributed (sharded.py) and its
process set-up (launch.py); the counterpart of reduced3dgs_tpu/parallel."""
