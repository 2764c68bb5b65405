"""One module per kind of loop a traffic mix names under ``loop``:
``setup(run)`` makes the program's state and warms up, ``window(run, st)``
measures for ``run.seconds``, ``finish(run, st)`` reads the port's outputs
back and frees its state, ``check(run, st)`` judges them against the
plain reference and returns {name: (reading, limit)}."""
