"""The plain float32 reference the outputs are judged by. Imports
nothing of the program under test."""
