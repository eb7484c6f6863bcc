"""The plain reference that decides ``correct``: plain Python and torch,
nothing of the program under test."""
