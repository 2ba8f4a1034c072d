from .test import TEST, SemSegTester, load_weights
