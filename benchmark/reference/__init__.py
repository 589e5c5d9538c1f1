"""The plain float32 reference that decides `correct`; it imports nothing of
the program under test."""
