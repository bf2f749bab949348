"""The program's side of each op, one file an op under the family's
directory (``ops/<kind>/<op>.py``), found by the op's name in the
traffic file: ``run(prog, op)`` does the op's part of one user call on
the program's state and returns the work it did; ``outputs(prog, op)``
what the check reads of it once the window has closed, where it has
any."""
