"""Scale-out on `torch.distributed`: factor-sharded bundle adjustment,
roll/pitch-sharded proposals, the two-stage front end and multi-process
runs."""
