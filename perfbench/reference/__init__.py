"""Plain references that decide ``correct``: CRUSH and the OSD map's
placement pipeline.  Frozen copies in plain Python and NumPy; they
import nothing of the program under test."""
