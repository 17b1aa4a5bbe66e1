"""Serve the web app (the port's counterpart of start_web_app.py).

    python -m univer_ocr_tpu_torch.web [port] [--cpu]

The OCR pipelines run on the card unless --cpu is given; the default
port is 8000.
"""

import sys

from . import create_app


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith('--')]
    port = int(args[0]) if args else 8000
    app = create_app(device='cpu' if '--cpu' in argv else None)
    app.run(host='127.0.0.1', port=port)


if __name__ == '__main__':
    main()
