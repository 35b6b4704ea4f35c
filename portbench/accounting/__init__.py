"""Operation and byte counts of the model's mathematics, from the
configuration's shapes, and the published peaks they are held to. The
counts are the same whatever implements the work, so that a change to the
program cannot move the yardstick."""
