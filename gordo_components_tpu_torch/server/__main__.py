"""``python -m gordo_components_tpu_torch.server --models-dir DIR [--port N] [--device cpu]``."""

from __future__ import annotations

import argparse
import logging

from .server import make_server


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m gordo_components_tpu_torch.server",
        description="Serve model artifacts on the GPU: the reference's core HTTP surface.",
    )
    parser.add_argument("--models-dir", required=True,
                        help="one artifact directory, or a directory of them")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5555)
    parser.add_argument("--project", default="project")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu; there is no silent fallback")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    httpd = make_server(args.models_dir, args.host, args.port, args.device, args.project)
    host, port = httpd.server_address[:2]
    logging.info("serving %s on http://%s:%d", sorted(httpd.model_server.machines), host, port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
