"""The port's copies of the stdlib-only analysis modules it needs at run
time (the wire spec).  The linter itself stays in the reference and is
run over the port as a tool."""
