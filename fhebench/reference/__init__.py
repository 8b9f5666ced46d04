"""The benchmark's yardstick: a plain AES-128, the comparison that decides
`correct`, frozen byte formulas of the program's kernels and the card's
peaks.  Nothing here imports the program."""
