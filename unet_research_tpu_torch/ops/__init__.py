"""Compute ops: image geometry and DropBlock; hand-written kernels live in
`ops.cuda`."""
