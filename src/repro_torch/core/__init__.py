"""The system: polyhedral front end (``poly``), programs, EDT runtime."""
