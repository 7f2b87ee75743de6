"""The plain reference the benchmark judges the monitor's answers by.

Plain PyTorch and NumPy; imports nothing of the program under test.
"""
