"""One module a regime: ``run(cell)`` makes the cell's set-up, opens the
window, sends its requests and closes the window; ``PARAMS`` names the
traffic file's keys it reads beyond those of every mix (the harness
refuses a traffic file with a key that nothing reads)."""
