"""The plain reference that ``check.py`` judges the program by."""
