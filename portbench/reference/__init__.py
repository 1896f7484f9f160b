"""The plain reference the port's frames are held to; imports nothing of the program."""
