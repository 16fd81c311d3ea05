"""The benchmark's yardstick, frozen: what a change to the program must not
be able to move. Each module names where it was copied from."""
