"""The benchmark's fixed measuring code: finding a cell's files by name,
making its inputs from the seed, the closed loop and its clock, the
reading of the device trace, the table of peaks and the operation and
byte counts, and the comparison that decides ``correct``.  Nothing here
imports the program under test at module level."""
