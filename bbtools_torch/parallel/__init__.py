"""Multi-device paths of the port: the (dp, tp) mesh of torch devices,
the sharded k-mer index and scan, sharded counting, scoring, insert scan,
fill and matcher steps, the hash-sharded spectrum, and the join of
several processes (`distributed.py`, gloo)."""
